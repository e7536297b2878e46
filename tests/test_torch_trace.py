"""PyTorch port: tracing hooks (utils/trace.py). RuntimeConfig.profile_dir
drops torch.profiler traces around FastLlama.generate and BatchEngine.run,
and device_op_breakdown parses them (the four cases of tests/test_trace.py),
plus the parser on a trace shaped like a CUDA run's."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import fastllama_tpu_torch
from fastllama_tpu_torch.engine.scheduler import BatchEngine, Request
from fastllama_tpu_torch.engine.session import FastLlama
from fastllama_tpu_torch.io.checkpoint import CheckpointWriter
from fastllama_tpu_torch.utils.trace import (
    device_op_breakdown, kernel_key, trace_region,
)

from test_torch_session import KW, write

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def tiny_model(tmp_path_factory):
    path = tmp_path_factory.mktemp("trace_ckpt") / "tiny"
    write(CheckpointWriter, path)
    return fastllama_tpu_torch.Model(str(path), device="cpu",
                                     logger=fastllama_tpu_torch.Logger(),
                                     **KW)._model


def test_trace_region_disabled_is_noop(tmp_path):
    with trace_region("", "x"):
        pass
    with trace_region(None, "x"):
        pass
    assert not list(tmp_path.iterdir())


def _greedy(model, n):
    model.reset()
    s = FastLlama(model, n_keep=24, seed=7)
    assert s.ingest(" w1 w2")
    out = []
    assert s.generate(out.append, num_tokens=n, temp=0.0)
    return "".join(out), s.get_logits().copy()


def test_session_generate_traced(tiny_model, tmp_path):
    """A traced generate streams what an untraced one does, and its trace
    (the innermost CPU operators of a CPU run) parses."""
    plain = _greedy(tiny_model, 3)
    tiny_model.rcfg = dataclasses.replace(tiny_model.rcfg,
                                          profile_dir=str(tmp_path))
    try:
        traced = _greedy(tiny_model, 3)
    finally:
        tiny_model.rcfg = dataclasses.replace(tiny_model.rcfg, profile_dir="")
    assert traced[0] == plain[0]
    np.testing.assert_array_equal(traced[1], plain[1])
    total, agg, cnt = device_op_breakdown(str(tmp_path / "generate"))
    assert sum(cnt.values()) > 0 and total > 0
    assert any(k.startswith("aten::") for k in agg)


def test_engine_run_traced(tiny_model, tmp_path):
    rcfg = dataclasses.replace(tiny_model.rcfg, profile_dir=str(tmp_path))
    eng = BatchEngine(tiny_model.hp, tiny_model.params, tiny_model.vocab,
                      n_slots=2, n_ctx=64, rcfg=rcfg, temp=0.0,
                      device="cpu")
    res = eng.run([Request(prompt=" w1", max_tokens=3, temp=0.0)])
    assert len(res[0].tokens_out) == 3
    assert os.path.isdir(tmp_path / "engine_run")
    total, agg, cnt = device_op_breakdown(str(tmp_path / "engine_run"))
    assert sum(cnt.values()) > 0


def test_breakdown_missing_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        device_op_breakdown(str(tmp_path))


def test_breakdown_counts_device_kernels_by_base_name(tmp_path):
    """A CUDA trace: kernels add up under their base name whatever their
    template arguments; memcpys count as device time; the host's
    cudaLaunchKernel calls and CPU operators do not; the newest file wins."""
    def ev(name, cat, ts, dur, tid=1):
        return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": tid,
                "ts": ts, "dur": dur}

    events = [
        ev("aten::mm", "cpu_op", 0, 50),
        ev("cudaLaunchKernel", "cuda_runtime", 1, 5),
        ev("void q4_fold_kernel<8, 0, false, true>(float const*, int, int)",
           "kernel", 10, 20, tid=7),
        ev("void (anonymous namespace)::q4_fold_kernel<64, 0, true, false>("
           "float const*, int, int)", "kernel", 40, 30, tid=7),
        ev("void attn_split_kernel<__nv_bfloat16, true>(float const*)",
           "kernel", 80, 6, tid=7),
        ev("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy", 90, 4, tid=8),
        {"ph": "M", "name": "process_name", "pid": 0,
         "args": {"name": "python"}},
    ]
    old = tmp_path / "a" / "1.old.pt.trace.json"
    old.parent.mkdir()
    old.write_text(json.dumps({"traceEvents": [ev("stale", "kernel", 0, 9)]}))
    new = tmp_path / "b" / "2.new.pt.trace.json"
    new.parent.mkdir()
    new.write_text(json.dumps({"traceEvents": events}))
    os.utime(old, ns=(1, 1))
    total, agg, cnt = device_op_breakdown(str(tmp_path))
    assert total == 60
    assert dict(agg) == {"q4_fold_kernel": 50, "attn_split_kernel": 6,
                         "Memcpy DtoH": 4}
    assert cnt["q4_fold_kernel"] == 2
    assert kernel_key("ampere_sgemm_128x64_nn") == "ampere_sgemm_128x64_nn"
    assert kernel_key("void at::native::elementwise_kernel<128, 4>(int)") \
        == "elementwise_kernel"
    assert kernel_key("void at::native::(anonymous namespace)::"
                      "softmax_warp_forward<float, 4>(float*)") \
        == "softmax_warp_forward"
    assert kernel_key("aten::mm") == "aten::mm"


def test_busy_us_counts_overlaps_once():
    """The device time of a trace is the time its spans cover: a kernel
    launched as a programmatic dependent starts before the one ahead of it
    ends, and that stretch counts once; disjoint spans add up, a span
    inside another adds nothing."""
    from fastllama_tpu_torch.utils.trace import busy_us
    assert busy_us([]) == 0
    assert busy_us([(10, 30), (40, 70)]) == 50
    assert busy_us([(40, 70), (10, 30), (25, 45)]) == 60
    assert busy_us([(0, 100), (10, 20), (50, 60)]) == 100

