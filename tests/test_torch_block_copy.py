"""The port's KV block gather/scatter (dynamo_tpu_torch.ops.block_copy, the
plain versions, and ops/kernels/block_copy.py, the CUDA kernels' wrapper)
against the JAX package, on the CPU:
- bitwise equal to the Pallas kernels ``gather_blocks`` / ``scatter_blocks``
  in interpret mode over ``[N, *block]`` pools (the KVBM's layout);
- bitwise equal to the engine's extract and inject functions
  (``JaxLlmEngine._build_extract`` / ``_build_inject``) over ``[L, N, ...]``
  cache leaves, for float32, float16, bfloat16 (compared as int16) and
  uint8 rows of 1000 bytes, with a cast to the pool's dtype;
- scatter leaves every untouched block bitwise unchanged;
- the wrapper refuses out-of-range and duplicate scatter ids, and a CPU
  tensor takes the plain version."""

import types

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from dynamo_tpu.engine import JaxLlmEngine
from dynamo_tpu.ops.pallas import gather_blocks as pallas_gather
from dynamo_tpu.ops.pallas import scatter_blocks as pallas_scatter
from dynamo_tpu_torch.ops import block_copy as plain
from dynamo_tpu_torch.ops.kernels import block_copy

# the numpy dtype of each case on the JAX side
DTYPES = {
    "float32": np.float32,
    "float16": np.float16,
    "bfloat16": ml_dtypes.bfloat16,
    "uint8": np.uint8,
}


def make(shape, name, seed):
    """The same values as a numpy array (JAX side) and a tensor (port)."""
    np_dtype = DTYPES[name]
    rng = np.random.default_rng(seed)
    if name == "uint8":
        arr = rng.integers(0, 256, shape, dtype=np.uint8)
    else:
        arr = (rng.standard_normal(shape) * 3).astype(np.float32).astype(np_dtype)
    if name == "bfloat16":
        tensor = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        tensor = torch.from_numpy(arr.copy())
    return arr, tensor


def bits(x) -> np.ndarray:
    """Raw bits, so bf16 and NaN payloads compare exactly."""
    if isinstance(x, torch.Tensor):
        x = x.contiguous()
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == ml_dtypes.bfloat16 else x


def assert_bitwise(ours, ref):
    np.testing.assert_array_equal(bits(ours), bits(ref))


SRC_IDS = [7, 2, 5, 0, 9]
DST_IDS = [1, 3, 9, 4, 6]


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_matches_pallas_kernels_on_kvbm_pools(dtype):
    shape = (10, 1000) if dtype == "uint8" else (10, 2, 4, 2, 16)
    pool_np, pool = make(shape, dtype, 0)
    ids = jnp.asarray(SRC_IDS, jnp.int32)
    ref = pallas_gather(jnp.asarray(pool_np), ids, interpret=True)
    out = plain.gather_blocks(pool, SRC_IDS)
    assert_bitwise(out, ref)

    blocks_np, blocks = make((len(DST_IDS), *shape[1:]), dtype, 1)
    ref_pool = pallas_scatter(jnp.asarray(pool_np), jnp.asarray(blocks_np),
                              jnp.asarray(DST_IDS, jnp.int32), interpret=True)
    ours = plain.scatter_blocks(pool.clone(), blocks, DST_IDS)
    assert_bitwise(ours, ref_pool)
    untouched = [i for i in range(shape[0]) if i not in DST_IDS]
    assert_bitwise(ours[untouched], pool[untouched])


def jax_engine_functions(num_blocks):
    """The reference engine's own extract and inject programs."""
    stub = types.SimpleNamespace(config=types.SimpleNamespace(num_blocks=num_blocks), mesh=None)
    return JaxLlmEngine._build_extract(stub), JaxLlmEngine._build_inject(stub)


LEAVES = {  # [L, N, ...]: llama k/v, DeepSeek latent and rope, a raw byte row
    "llama": (3, 12, 4, 2, 16),
    "latent": (2, 12, 4, 1, 32),
    "rope": (2, 12, 4, 1, 8),
    "bytes": (2, 12, 1000),
}


# cache leaves are floating point; the byte rows are uint8 payloads
LEAF_CASES = [(leaf, dtype) for leaf in ("llama", "latent", "rope")
              for dtype in ("bfloat16", "float16", "float32")] + [("bytes", "uint8")]


@pytest.mark.parametrize("leaf,dtype", LEAF_CASES, ids=lambda v: str(v))
def test_wrapper_matches_engine_extract_and_inject(leaf, dtype):
    shape = LEAVES[leaf]
    extract, inject = jax_engine_functions(shape[1])
    cache_np, cache = make(shape, dtype, 2)
    ref = extract({"c": jnp.asarray(cache_np)}, jnp.asarray(SRC_IDS, jnp.int32))["c"]
    before = block_copy.plain_calls
    out = block_copy.gather_blocks(cache, SRC_IDS, axis=1)
    assert block_copy.plain_calls == before + 1
    assert_bitwise(out, ref)

    # float32 blocks into a narrower cache: the cast to the pool's dtype is
    # part of the copy
    blocks_dtype = "uint8" if dtype == "uint8" else "float32"
    new_np, new = make((shape[0], len(DST_IDS), *shape[2:]), blocks_dtype, 3)
    ref_cache = inject({"c": jnp.asarray(cache_np)}, {"c": jnp.asarray(new_np)},
                       jnp.asarray(DST_IDS, jnp.int32), jnp.int32(len(DST_IDS)))["c"]
    ours = block_copy.scatter_blocks(cache.clone(), new, DST_IDS, axis=1)
    assert ours.dtype == cache.dtype
    assert_bitwise(ours, ref_cache)
    untouched = [i for i in range(shape[1]) if i not in DST_IDS]
    assert_bitwise(ours[:, untouched], cache[:, untouched])


def test_gather_then_scatter_roundtrip_on_the_block_axis():
    _, pool = make((3, 10, 4, 2, 16), "bfloat16", 4)
    moved = block_copy.scatter_blocks(torch.zeros_like(pool),
                                      block_copy.gather_blocks(pool, SRC_IDS, axis=1),
                                      DST_IDS, axis=1)
    assert_bitwise(moved[:, DST_IDS], pool[:, SRC_IDS])
    assert not moved[:, [0, 2, 5, 7, 8]].any()


@pytest.mark.parametrize("ids", [[10], [-1], [0, 12]])
def test_out_of_range_ids_are_refused(ids):
    pool = torch.zeros((10, 4))
    with pytest.raises(ValueError, match="outside the pool"):
        block_copy.gather_blocks(pool, ids)
    with pytest.raises(ValueError, match="outside the pool"):
        block_copy.scatter_blocks(pool, torch.zeros((len(ids), 4)), ids)


def test_duplicate_scatter_ids_are_refused_and_gather_repeats_allowed():
    pool = torch.arange(40.0).reshape(10, 4)
    with pytest.raises(ValueError, match="duplicate scatter block ids \\[3\\]"):
        block_copy.scatter_blocks(pool, torch.zeros((3, 4)), [3, 1, 3])
    assert torch.equal(block_copy.gather_blocks(pool, [3, 3]), pool[[3, 3]])


def test_shape_mismatch_and_bad_axis_are_refused():
    pool = torch.zeros((2, 10, 4))
    with pytest.raises(ValueError, match="do not fit"):
        block_copy.scatter_blocks(pool, torch.zeros((2, 3, 4)), [0, 1], axis=1)
    with pytest.raises(ValueError, match="block axis"):
        block_copy.gather_blocks(pool, [0], axis=3)


def test_cpu_tensors_take_the_plain_version():
    pool = torch.zeros((4, 8))
    before = (block_copy.plain_calls, block_copy.gather_launches, block_copy.scatter_launches)
    block_copy.gather_blocks(pool, [1])
    block_copy.scatter_blocks(pool, torch.ones((1, 8)), [2])
    assert block_copy.plain_calls == before[0] + 2
    assert (block_copy.gather_launches, block_copy.scatter_launches) == before[1:]
    assert pool[2].eq(1).all() and not pool[[0, 1, 3]].any()


def test_other_devices_are_refused():
    pool = torch.zeros((4, 8), device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        block_copy.gather_blocks(pool, [1])
    with pytest.raises(ValueError, match="unsupported device"):
        block_copy.scatter_blocks(pool, torch.zeros((1, 8), device="meta"), [1])
