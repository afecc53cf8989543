"""The reference's Pallas scatters on the installed JAX.

``repro.kernels.paged_cache`` (``_scatter_kernel`` and the quantizing
scatter's kernel) calls ``pl.load``, which newer JAX releases no longer
export from ``jax.experimental.pallas``. The primitive is still there, as
``jax._src.pallas.primitives.load``, with the same signature and, without a
mask, the semantics of ``ref[idx]``. Without the name every reference test
that runs a fleet, a speculative round or a scatter fails while it traces,
and a few others pass or fail by which test file ran before them in the same
process: the reference caches its compiled decode step by model, so a step
traced on the scatters' jnp oracles by another file is reused.

The reference's fleet tests also race on the installed JAX: they pass
``jnp.asarray(pool.lengths)`` to a jitted step and then bump
``pool.lengths`` in place. On the CPU ``jnp.asarray`` wraps an aligned
numpy array without copying it and the step is dispatched asynchronously,
so the step may read the bumped lengths (test_spec.py's verify-vs-decode
case then fails in some runs and passes in others, whatever ran before
it). Dispatching CPU computations synchronously removes the race.

pytest imports every test module before it runs any test, so importing this
one gives the name back and makes CPU dispatch synchronous for the whole
session, and the reference's tests run its own Pallas kernels in interpret
mode. Nothing of the JAX package changes.

* ``pl.load`` is the Pallas load primitive;
* CPU dispatch is synchronous (the import raises if a backend was made
  before it, so the whole file fails to collect), and a jitted call reads
  a wrapped numpy array as it was at the call, though the array is changed
  right after;
* a Pallas kernel that loads a row through it, in interpret mode, reads what
  ``ref[idx]`` reads, at the first, a middle and the last row;
* the reference's ``paged_scatter`` equals ``paged_scatter_ref`` bit for bit
  on an fp32 pool, and ``paged_scatter_quant`` equals
  ``paged_scatter_quant_ref`` on int8 and fp8 pools (rows bit for bit,
  scales to the ULP, as the reference's own round-trip test holds them).
"""
import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
from jax._src import xla_bridge as _xla_bridge
from jax._src.pallas import primitives as _pallas_primitives

# Deliberately left set for the whole session (only markers may be added
# to tests/conftest.py): the reference's test_fleet.py, test_watch.py,
# test_obs.py (its fleet and chaos cases), test_spec.py, test_kernels.py and
# test_paged_attention.py (their scatter cases) reach the Pallas scatters
# and fail without it. Do not delete or rename this file.
if not hasattr(pl, "load"):
    pl.load = _pallas_primitives.load

# Read once, when the process's CPU client is made, and that client serves
# every test file the process runs: so no narrower scope exists, and a
# client made before this import would leave the race in place unseen.
if _xla_bridge._backends:
    raise RuntimeError(
        "a JAX backend was made before tests/test_torch_reference_compat.py "
        "was imported, so CPU dispatch cannot be made synchronous and the "
        "reference's fleet tests race (see the module docstring)")
jax.config.update("jax_cpu_enable_async_dispatch", False)

from repro.kernels import paged_cache as jax_paged_cache  # noqa: E402


def test_pallas_exports_load():
    assert pl.load is _pallas_primitives.load


def test_cpu_dispatch_is_synchronous():
    assert _xla_bridge._CPU_ENABLE_ASYNC_DISPATCH.value is False
    f = jax.jit(lambda m, n: (m @ m).sum() * 0 + n.sum())
    m = jnp.ones((256, 256))
    for _ in range(50):
        n = np.zeros(64, np.int32)
        out = f(m, jnp.asarray(n))
        n += 1                     # what the reference's pool does
        assert int(out) == 0


@pytest.mark.parametrize("row", [0, 2, 4])
def test_pallas_load_reads_what_indexing_reads(row):
    x = np.random.default_rng(row).standard_normal((5, 8)).astype(np.float32)

    def kernel(x_ref, o_ref):
        o_ref[...] = pl.load(x_ref, (pl.dslice(row, 1), slice(None)))

    got = pl.pallas_call(kernel,
                         out_shape=jax.ShapeDtypeStruct((1, 8), jnp.float32),
                         interpret=True)(jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(got), x[row:row + 1])


def _writes(nb):
    wslot = np.full((nb,), -1, np.int32)
    woff = np.zeros((nb,), np.int32)
    for slot, (blk, off) in enumerate([(2, 1), (5, 3), (9, 0)]):
        wslot[blk], woff[blk] = slot, off
    return jnp.asarray(wslot), jnp.asarray(woff)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.int8, jnp.float8_e4m3fn],
                         ids=["fp32", "int8", "fp8"])
def test_reference_scatter_matches_its_oracle(dtype):
    nb, bs, kvh, hd, s = 12, 4, 2, 8, 3
    rng = np.random.default_rng(7)
    new = jnp.asarray(rng.standard_normal((s, kvh, hd)).astype(np.float32)
                      * 2.0)
    wslot, woff = _writes(nb)
    if dtype == jnp.float32:
        pool = jnp.asarray(rng.standard_normal((nb, bs, kvh, hd))
                           .astype(np.float32))
        got = jax_paged_cache.paged_scatter(pool, new, wslot, woff,
                                            interpret=True)
        want = jax_paged_cache.paged_scatter_ref(pool, new, wslot, woff)
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
        return
    pool = jnp.zeros((nb, bs, kvh, hd), dtype)
    scales = jnp.zeros((nb, bs))
    got = jax_paged_cache.paged_scatter_quant(pool, scales, new, wslot, woff,
                                              interpret=True)
    want = jax_paged_cache.paged_scatter_quant_ref(pool, scales, new, wslot,
                                                   woff)
    np.testing.assert_array_equal(np.asarray(got[0]).view(np.uint8),
                                  np.asarray(want[0]).view(np.uint8))
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]),
                               rtol=1e-6, atol=0)
