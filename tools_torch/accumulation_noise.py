#!/usr/bin/env python3
"""How far bf16-mode logits move when only the summation precision changes.

    python3 tools_torch/accumulation_noise.py     # from the repository root

Runs on the CPU (plain versions). Writes a q4_0 and a q4_1 GGJT file as
chip_smoke.py does (2 layers, n_embd 1024, n_vocab 2048), loads each with
bf16 weights and KV, and evaluates a 21-token window twice: with the plain
versions as they are (f32 accumulation) and with their matmuls accumulated
in f64. Prints the largest logit difference over the largest logit.

This is the noise floor a comparison of the card with the CPU can reach in
bf16 mode, whatever the kernels do: q4_0 sums are products of two bf16
values and nearly exact in f32, so the two runs agree to ~1e-7; the affine
form's mins term has f32 operands, so every sum differs in its last bit,
and each bf16 rounding of an activation turns a difference d into about
sqrt(d * 2^-8), which settles at the bf16 step (~1e-2) within a few
matmuls. chip_smoke.py's tolerance for a q4_1 file follows from it.
"""
import dataclasses
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402
from fastllama_tpu_torch.config import PRESETS, RuntimeConfig  # noqa: E402
from fastllama_tpu_torch.kernels import q4_matmul as qm  # noqa: E402
from fastllama_tpu_torch.models.loader import load_model  # noqa: E402
from fastllama_tpu_torch.quant.tensor import QBLOCK, unpack_codes  # noqa: E402


def dequant_f64(x, w, w_dtype=torch.bfloat16):
    """q4_matmul_dequant with the sum in f64."""
    x2 = qm._pad_k(x, w.k).to(w_dtype).double()
    dense = qm.dequant_matmul_weight(w, w_dtype).double()
    return (x2 @ dense).float()[:, :w.n_logical]


def q41_plain_f64(x, w, w_dtype=torch.bfloat16):
    """q41_matmul_decode_plain with both sums in f64."""
    kh, n = w.qs.shape
    nb = kh // (QBLOCK // 2)
    xp = qm._pad_k(x.float(), w.k)
    codes = unpack_codes(w.qs.reshape(nb, QBLOCK // 2, n), 1)
    qd = (codes.float() * w.scales.reshape(nb, 1, n)).to(w_dtype)
    y = xp.to(w_dtype).double() @ qd.reshape(w.k, n).double()
    bsum = xp.double().reshape(xp.shape[0], nb, QBLOCK).sum(-1)
    return (y + bsum @ w.mins.double()).float()[:, :w.n_logical]


def main() -> int:
    torch.set_num_threads(4)
    hp = dataclasses.replace(PRESETS["7B"], n_vocab=2048, n_embd=1024,
                             n_head=8, n_layer=2)
    toks = [1] + list(range(300, 320))
    plain = (qm.q4_matmul_dequant, qm.q41_matmul_decode_plain)
    with tempfile.TemporaryDirectory() as tmp:
        for affine in (False, True):
            path = str(Path(tmp) / f"affine_{affine}.bin")
            cs.write_ggjt_file(path, hp, 7, affine=affine)
            logits = []
            for fns in (plain, (dequant_f64, q41_plain_f64)):
                qm.q4_matmul_dequant, qm.q41_matmul_decode_plain = fns
                try:
                    lm = load_model(path, RuntimeConfig(n_ctx=512, n_batch=64),
                                    device="cpu")
                    logits.append(lm.eval(0, toks))
                finally:
                    qm.q4_matmul_dequant, qm.q41_matmul_decode_plain = plain
            rel = np.abs(logits[0] - logits[1]).max() / np.abs(logits[1]).max()
            print(f"{'q4_1' if affine else 'q4_0'} bf16 mode, f32 vs f64 "
                  f"accumulation on the CPU: rel err {rel:.3g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
