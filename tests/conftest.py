"""Test configuration: CPU JAX with 8 virtual devices, seeded corpus.

The standard JAX trick for testing multi-device sharding without a cluster
(SURVEY.md §4.4): `--xla_force_host_platform_device_count=8` gives an
8-device CPU mesh; shard_map code is identical on a CPU mesh and a GPU mesh.
The platform is pinned to the CPU in code as well as by `JAX_PLATFORMS`, so
the suite never claims an accelerator.  Tests that need a GPU carry the
`gpu` marker and skip here (the card runs them through `chip_smoke.py`).

Corpus images come from the seeded generator in `tools/corpus.py`.
"""

import os
import sys

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")
if "--xla_force_host_platform_device_count" not in os.environ["XLA_FLAGS"]:
    os.environ["XLA_FLAGS"] += " --xla_force_host_platform_device_count=8"

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))

import pytest  # noqa: E402

import corpus  # noqa: E402

CORPUS = [
    "img.jpg", "img2.jpg", "img3.jpg", "img4.jpg", "img5.jpg", "img6.jpg",
]
PROGRESSIVE_CORPUS = ["prograssive-sample-2.jpg", "prograssive-sample.jpg"]
CORPUS_SEED = 0


def corpus_path(name: str) -> str:
    """Path of a seeded corpus image, generated on first use."""
    return corpus.path(name, CORPUS_SEED)


#: The seeded corpus resynchronises more slowly than the real photos the
#: production overflow window (entropy_spec._adaptive_ovf, 13x the average
#: MCU bytes) was fitted on: its speculative lanes need up to ~28x the
#: average at 1-4 KiB chunks.
CORPUS_SYNC_X = 32


@pytest.fixture
def corpus_sync_window(monkeypatch):
    """Give the speculative splice the overflow window the seeded corpus
    needs, so splice tests pin the splice itself, not the window's fit."""
    from jpeg_decoder_tpu.ops import entropy_spec

    def window(n_bytes: int, n_mcus: int) -> int:
        avg = n_bytes / max(1, n_mcus)
        return int(min(1536, max(512, CORPUS_SYNC_X * avg)))

    monkeypatch.setattr(entropy_spec, "_adaptive_ovf", window)


@pytest.fixture(scope="session")
def oracle():
    """Instrumented-reference oracle (built once per session)."""
    import oracle as oracle_mod

    if not oracle_mod.available():
        pytest.skip("oracle toolchain unavailable")
    return oracle_mod


@pytest.fixture(autouse=True, scope="module")
def _release_compiled_programs():
    """Drop jax's compiled-executable caches between test MODULES.

    Every compiled XLA CPU executable holds several memory mappings;
    the suite compiles hundreds of program variants and a long pytest
    process walks into vm.max_map_count (default 65530) late in the
    run — LLVM then fails its code-page mmap ("Cannot allocate
    memory") and the process segfaults.  Clearing per module keeps the
    map count bounded at a small recompile cost; within-module sharing
    (the expensive, shape-heavy fixtures) is preserved.
    """
    yield
    import gc

    import jax

    jax.clear_caches()
    gc.collect()
