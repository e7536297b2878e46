"""PyTorch port: the batched on-device sampler (sample_device) against the
JAX package's sample_jax under the same uniforms."""
import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fastllama_tpu.engine.sampling import sample_jax
from fastllama_tpu_torch.engine.sampling import draw_uniforms, sample_device

torch.set_num_threads(1)


def jax_uniforms(seed, b, k):
    """The uniforms sample_jax draws from this key, and the key."""
    key = jax.random.PRNGKey(seed)
    return key, np.array(jax.random.uniform(key, (b, k), minval=1e-20,
                                            maxval=1.0))


def both(logits, lastn, seed, top_k, top_p, temp, rp, top_k_v):
    """Token ids of (port, jax) for one call; array knobs go to both as
    vectors, python floats as floats."""
    b, v = logits.shape
    k = min(top_k if top_k > 0 else v, v)
    key, u = jax_uniforms(seed, b, k)

    def j(x, dt):
        return x if isinstance(x, (int, float)) else jnp.asarray(x, dt)

    def t(x, dt):
        return x if isinstance(x, (int, float)) else torch.from_numpy(
            np.asarray(x)).to(dt)

    want = sample_jax(jnp.asarray(logits), jnp.asarray(lastn), key,
                      top_k=top_k, top_p=j(top_p, jnp.float32),
                      temp=j(temp, jnp.float32),
                      repeat_penalty=j(rp, jnp.float32),
                      top_k_v=None if top_k_v is None
                      else jnp.asarray(top_k_v, jnp.int32))
    got = sample_device(torch.from_numpy(logits), torch.from_numpy(lastn),
                        torch.from_numpy(u), top_k=top_k,
                        top_p=t(top_p, torch.float32),
                        temp=t(temp, torch.float32),
                        repeat_penalty=t(rp, torch.float32),
                        top_k_v=None if top_k_v is None
                        else torch.from_numpy(np.asarray(top_k_v, np.int32)))
    assert got.dtype == torch.int32 and got.shape == (b,)
    return got.numpy(), np.asarray(want)


def random_case(seed, b=8, v=300, w=12):
    rng = np.random.default_rng(seed)
    logits = (rng.standard_normal((b, v)) * 3).astype(np.float32)
    lastn = rng.integers(0, v, (b, w)).astype(np.int32)
    lastn[:, :4] = -1                              # pads
    lastn[0, 5] = v + 7                            # clips to v - 1
    lastn[1] = -1                                  # an empty window
    temp = rng.uniform(0.3, 1.5, b).astype(np.float32)
    temp[2], temp[3] = 0.0, -1.0                   # greedy rows
    top_p = rng.uniform(0.3, 1.0, b).astype(np.float32)
    top_p[4], top_p[5] = 1.0, 1e-6
    rp = rng.uniform(1.0, 1.8, b).astype(np.float32)
    rp[6] = 1.0
    top_k_v = rng.integers(1, 41, b).astype(np.int32)
    top_k_v[7] = 1
    return logits, lastn, temp, top_p, rp, top_k_v


@pytest.mark.parametrize("seed", range(8))
def test_per_row_knobs_match_sample_jax(seed):
    logits, lastn, temp, top_p, rp, top_k_v = random_case(seed)
    got, want = both(logits, lastn, seed, 40, top_p, temp, rp, top_k_v)
    np.testing.assert_array_equal(got, want)
    # greedy rows, the tiny top_p and top_k_v = 1 all give the argmax of
    # what they look at
    assert got[2] == logits[2].argmax() and got[3] == logits[3].argmax()


@pytest.mark.parametrize("top_k,top_p,temp,rp", [
    (40, 0.95, 0.8, 1.0),        # the engine's defaults, all static
    (40, 1.0, 0.8, 1.3),         # a static top_p >= 1 skips the cut
    (0, 0.9, 1.2, 1.1),          # top_k 0: the whole vocabulary
    (5, 0.5, 0.0, 1.5),          # static greedy
    (500, 0.95, 0.7, 1.0),       # a cap above the vocabulary
])
def test_static_knobs_match_sample_jax(top_k, top_p, temp, rp):
    logits, lastn, *_ = random_case(21)
    for seed in (1, 2, 3):
        got, want = both(logits, lastn, seed, top_k, top_p, temp, rp, None)
        np.testing.assert_array_equal(got, want)


def test_ties_keep_the_lowest_token_id():
    """Equal scaled logits: jax.lax.top_k orders them by index; the port's
    stable sort must pick the same members of a tie that straddles k."""
    logits = np.zeros((3, 50), np.float32)
    logits[0, [7, 30, 31, 44]] = 2.0               # four tied leaders, k = 2
    logits[1, :] = 1.0                             # all tied
    logits[2, [49, 3]] = [5.0, 5.0]
    lastn = np.full((3, 4), -1, np.int32)
    for seed in range(5):
        got, want = both(logits, lastn, seed, 2, 1.0,
                         np.full(3, 0.9, np.float32), 1.0,
                         np.array([2, 2, 1], np.int32))
        np.testing.assert_array_equal(got, want)
        assert got[0] in (7, 30) and got[1] in (0, 1) and got[2] == 3


def test_penalty_sign_test_is_on_the_raw_logit():
    """A token in the window is divided by the penalty when its raw logit
    is positive and multiplied when negative, whatever the temperature."""
    logits = np.array([[2.0, 1.9, -0.1, -0.2]], np.float32)
    lastn = np.array([[0, 2, -1]], np.int32)
    got, want = both(logits, lastn, 0, 4, 1e-6,
                     np.array([0.5], np.float32),
                     np.array([2.0], np.float32), None)
    np.testing.assert_array_equal(got, want)
    assert got[0] == 1                             # 2.0 / 2 < 1.9


def test_draw_uniforms_range_and_determinism():
    gen = torch.Generator(device="cpu")
    gen.manual_seed(5)
    a = draw_uniforms(gen, 4, 40, "cpu")
    gen.manual_seed(5)
    b = draw_uniforms(gen, 4, 40, "cpu")
    assert a.shape == (4, 40) and a.dtype == torch.float32
    assert torch.equal(a, b)
    assert float(a.min()) >= 1e-20 and float(a.max()) < 1.0


def test_sampled_tokens_follow_the_distribution():
    """With the port's own uniforms the draw follows the softmax of the
    kept set (a chi-square-free check: the empirical shares of a 3-token
    distribution within 3 sigma)."""
    logits = np.log(np.array([[0.6, 0.3, 0.1] + [1e-9] * 5], np.float32))
    n = 4000
    gen = torch.Generator(device="cpu")
    gen.manual_seed(0)
    ids = sample_device(torch.from_numpy(np.repeat(logits, n, 0)),
                        torch.full((n, 2), -1, dtype=torch.int32),
                        draw_uniforms(gen, n, 3, "cpu"), top_k=3, top_p=1.0,
                        temp=1.0, repeat_penalty=1.0).numpy()
    shares = np.bincount(ids, minlength=3)[:3] / n
    for share, p in zip(shares, (0.6, 0.3, 0.1)):
        assert abs(share - p) < 3 * np.sqrt(p * (1 - p) / n)
