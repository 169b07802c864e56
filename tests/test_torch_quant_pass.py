"""pack_quant_rows' routes on the card (``repro_torch/kernels/reshard_quant.py``
and ``csrc/reshard_quant.cu``), on the CPU: the pure function that picks a
route from a tile's size (a warp a tile in registers, a block a tile in
shared memory, one cooperative launch over the card beyond), at each
boundary and at
the training path's two shapes; the plain version, which the card's every
route is held to bit for bit by ``chip_smoke.py``, bitwise equal to the JAX
package's Pallas kernel in interpret mode and its reference at tiles on both
sides of each boundary, int8 and fp8-e4m3 from float32 and bfloat16; and
the route limits and codes of the CUDA source against the wrapper's
constants."""

from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro.kernels.reshard_quant import pack_quant_rows_pallas
from repro_torch.kernels import ops
from repro_torch.kernels import reshard_pack as rp
from repro_torch.kernels import reshard_quant as rq

torch.set_num_threads(2)

CSRC = Path(rq.__file__).resolve().parent / "csrc"
ITEMSIZE = {"float32": 4, "bfloat16": 2}
# qwen3-1.7b's moments on the training path's streamed resize: one layer row
# of a stacked moment (mlp/wi_gate, 2048 x 6144 fp32) and one embedding row
STACKED_ROW, EMBED_ROW = 2048 * 6144, 2048


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8)


def _boundaries(itemsize: int) -> dict[str, int]:
    """Tile sizes (elements) on both sides of each boundary."""
    w, b = rq.WARP_BYTES // itemsize, rq.BLOCK_BYTES // itemsize
    return {"warp_max": w, "block_min": w + 1, "block_min_vec": w + 8, "block_max": b, "grid_min": b + 1,
            "grid_min_vec": b + 8}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_route_at_each_boundary(dtype):
    it = ITEMSIZE[dtype]
    want = {"warp_max": "warp", "block_min": "block", "block_min_vec": "block", "block_max": "block",
            "grid_min": "grid", "grid_min_vec": "grid"}
    for name, elems in _boundaries(it).items():
        assert rq.route(elems, it) == want[name], (name, elems)
    assert rq.route(1, it) == "warp"


def test_the_route_at_the_training_paths_shapes():
    """A stacked moment's layer row (12.58 M fp32, 50.3 MB) takes the grid
    route, an embedding-moment row (2048 fp32, 8 KB) a warp, as do the
    norms' rows; blocks of rows take the route of their tile."""
    assert rq.route(STACKED_ROW, 4) == "grid"
    assert rq.route(EMBED_ROW, 4) == "warp"
    assert rq.route(128, 4) == "warp"
    assert rq.route(24 * EMBED_ROW, 4) == "block" and rq.route(25 * EMBED_ROW, 4) == "grid"
    assert rq.route(EMBED_ROW, 2) == "warp" and rq.route(2 * EMBED_ROW, 2) == "warp"


def test_the_grid_scratch():
    """The grid route's two slots of one maximum a block, one block an SM,
    for any card of up to _MAX_SMS SMs (an H100 has 132); the other routes
    need none."""
    assert rq.scratch_floats("grid") == 2 * rq._MAX_SMS >= 2 * 132
    assert rq.scratch_floats("warp") == rq.scratch_floats("block") == 0


@pytest.mark.parametrize("fmt", ["int8", "fp8_e4m3"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("side", ["warp_max", "block_min", "block_min_vec", "block_max", "grid_min_vec"])
def test_plain_equals_the_pallas_kernel_at_each_boundary(side, dtype, fmt):
    """Tiles of one row of C elements (C on one side of a boundary), with a
    repeated start, and tiles of two rows at block-aligned starts (twice C:
    the next route's side), against the Pallas kernel in interpret mode and
    the JAX reference, byte for byte."""
    C = _boundaries(ITEMSIZE[dtype])[side]
    rng = np.random.default_rng(C + len(fmt))
    src = rng.normal(size=(6, C)) * 10.0 ** rng.integers(-6, 6, (6, 1))
    js = jnp.asarray(src, getattr(jnp, dtype))
    ts = torch.from_numpy(np.asarray(js, np.float32).copy()).to(getattr(torch, dtype))
    for starts, block in (([4, 0, 4], 1), ([2, 0], 2)):
        q_t, s_t = ops.pack_quant_rows(ts, starts, block, fmt)
        st = jnp.asarray(np.asarray(starts, np.int32))
        q_p, s_p = pack_quant_rows_pallas(js, st, block, fmt, interpret=True)
        q_j, s_j = jax_ref.pack_quant_rows_ref(js, st, block, fmt)
        for got, want in ((q_t, q_p), (s_t, s_p), (q_t, q_j), (s_t, s_j)):
            np.testing.assert_array_equal(_np(got), _np(want))


def _constants(text: str) -> dict[str, int]:
    found = dict(re.findall(r"constexpr (?:int|int64_t) (k\w+) = ([\d* ]+);", text))
    return {k: eval(v) for k, v in found.items()}  # products of literals only


def test_the_route_limits_match_the_cuda_source():
    """The limits the wrapper's route() uses are the source's, which exports
    them for the wrapper to check at load; the route codes, the grid
    route's scratch and the by-value capacity are one on both sides."""
    text = (CSRC / "reshard_quant.cu").read_text()
    k = _constants(text)
    assert k["kWarpBytes"] == rq.WARP_BYTES and k["kBlockBytes"] == rq.BLOCK_BYTES
    codes = {name: k[f"kRoute{name.capitalize()}"] for name in rq._ROUTE_CODES}
    assert codes == rq._ROUTE_CODES
    # a warp holds its tile in 256 bytes a lane; a block's stage fits the
    # 227 KB a block may take, and with a grid-route block's registers
    # (kHeldBytes a thread) within 64K registers of an SM
    assert k["kWarpBytes"] == 32 * 256 and k["kBlockBytes"] <= 227 * 1024
    assert k["kGridThreads"] * (k["kHeldBytes"] // 4) <= 65536 // 2
    header = (CSRC / "row_tables.cuh").read_text()
    classes = re.search(r"constexpr int kStartClasses\[\] = \{([\d,\s]+)\};", header)
    assert [int(x) for x in classes.group(1).split(",")][-1] == rq.PARAM_STARTS == rp.PARAM_STARTS
    # pack's parameters: four pointers, two int64, two floats and the starts
    assert 4 * 8 + 2 * 8 + 2 * 4 + 4 + 4 * rq.PARAM_STARTS <= 32764


def test_the_pack_entries_take_their_starts_by_value():
    """Both pack entries launch through with_starts (by value up to the
    capacity, the device table past it), and nothing in the wrapper copies
    a table to the card per call."""
    text = (CSRC / "reshard_quant.cu").read_text()
    launch = text[text.index("int launch_pack("):]
    assert re.search(r"with_starts\s*\(", launch[: launch.index("\n}\n")])
    for entry in ("repro_pack_quant_rows", "repro_pack_quant_rows_list"):
        body = text[text.index(f"int {entry}("):]
        assert re.search(r"pack_entry\s*\(", body[: body.index("\n}\n")]), entry
    wrapper = Path(rq.__file__).read_text()
    assert "pin_memory" not in wrapper and "def _table(" not in wrapper


def test_the_cuda_wrapper_refuses_before_any_launch():
    x = torch.zeros(8, 16)
    with pytest.raises(ValueError, match="CUDA"):
        rq.pack_quant_rows_cuda(x, [0], 1, "int8")
    with pytest.raises(ValueError, match="CUDA"):
        rq.pack_quant_rows_cuda(x, [0.5], 1, "int8")
