"""Checks that need a GPU.  They skip elsewhere; chip_smoke.py runs the same
checks at full size on the card (phase d)."""

import numpy as np
import pytest


@pytest.fixture
def gpu():
    import jax

    try:
        return jax.devices("gpu")[0]
    except RuntimeError:
        pytest.skip("no GPU: chip_smoke.py runs these checks on the card")


@pytest.mark.gpu
@pytest.mark.parametrize("idct", ["fast", "kron"])
def test_gpu_idct_within_one_count(gpu, idct):
    import jax
    import jax.numpy as jnp

    from jpeg_decoder_tpu.ops import pixel as P

    rng = np.random.default_rng(0)
    blocks = rng.integers(-64, 64, size=(4096, 64)).astype(np.int32)
    q = rng.integers(1, 60, size=(64,)).astype(np.int32)
    deq = blocks.astype(np.int64) * q
    want = np.matmul(np.matmul(P.IDCT_M, deq.reshape(-1, 8, 8)),
                     P.IDCT_M.T).reshape(-1, 64)
    b, qq = jax.device_put(blocks, gpu), jax.device_put(q, gpu)
    if idct == "kron":
        got = P.idct_kron(b, qq)
    else:
        got = P.idct_fast((b * qq).reshape(-1, 8, 8)).reshape(-1, 64)
    assert np.abs(np.asarray(got) - want).max() <= 1.0


@pytest.mark.gpu
def test_gpu_strict_exact_matches_cpu(gpu):
    import jax

    from conftest import corpus_path
    from jpeg_decoder_tpu import decode

    blob = open(corpus_path("img2.jpg"), "rb").read()
    a = decode(blob, idct="exact", strict=True, device=gpu).rgb
    b = decode(blob, idct="exact", strict=True,
               device=jax.devices("cpu")[0]).rgb
    assert np.array_equal(a, b)
