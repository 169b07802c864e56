"""Non-integer row starts are refused with the port's ``ValueError``, on the
CPU, through every row and quant entry of ``repro_torch.kernels.ops``,
whatever the form of the starts: a list of one start or of many (the
executor's form, read by ``struct`` in ``ref.row_starts``), a tuple, a float
numpy array and a float tensor. The JAX package truncates such a start
(``jnp.asarray(row_starts, jnp.int32)``); no caller builds one, and the port
refuses it as it refuses a start outside the array. Integer forms of every
kind and the empty list pass, equal to the JAX references. On the card the
list entries of the CUDA libraries read a list themselves: the shared header
``csrc/row_tables.cuh`` turns a non-integer item into a code (its Python
error cleared) that the wrappers turn into the same refusal, which
``chip_smoke.py`` checks there; here the test holds the codes of the header
and the wrappers equal."""

from __future__ import annotations

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro_torch.kernels import ops, ref
from repro_torch.kernels import reshard_pack as rp
from repro_torch.kernels import reshard_quant as rq

torch.set_num_threads(2)

CSRC = Path(rq.__file__).resolve().parent / "csrc"
ROWS, C = 12, 8

NON_INTEGER = {  # each names the start 1.5
    "list_of_one": lambda: [1.5],
    "list_of_many": lambda: [0, 1.5, 4],
    "list_of_many_float_last": lambda: [0, 4, 1.5],
    "tuple": lambda: (0, 1.5),
    "numpy_float": lambda: np.array([0.0, 1.5]),
    "numpy_float32": lambda: np.array([1.5], dtype=np.float32),
    "tensor_float": lambda: torch.tensor([0.0, 1.5]),
    "tensor_bfloat16": lambda: torch.tensor([1.5, 0.0], dtype=torch.bfloat16),
}

INTEGER = {
    "empty_list": lambda: [],
    "empty_tuple": lambda: (),
    "empty_int_array": lambda: np.array([], dtype=np.int32),
    "list_of_one": lambda: [5],
    "list_of_many": lambda: [5, 0, 9],
    "tuple": lambda: (5, 0, 9),
    "numpy_int32": lambda: np.array([5, 0, 9], dtype=np.int32),
    "numpy_uint8": lambda: np.array([5, 0, 9], dtype=np.uint8),
    "numpy_ints_in_a_list": lambda: [np.int64(5), np.int32(0), 9],
    "tensor_int64": lambda: torch.tensor([5, 0, 9]),
    "numpy_scalar": lambda: np.int64(5),
}


def _src(dtype=torch.float32, seed=0) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(ROWS, C)).astype(np.float32)).to(dtype)


def _entries(starts):
    """Each ops row and quant entry on ``starts`` (blocks of one row)."""
    nb = len(starts) if hasattr(starts, "__len__") else 1
    src = _src()
    q, s = torch.zeros((nb, C), dtype=torch.int8), torch.ones((nb, 1))
    return {
        "pack_rows": lambda: ops.pack_rows(src, starts, 1),
        "unpack_rows": lambda: ops.unpack_rows(src[:nb], starts, 1, ROWS),
        "scatter_rows": lambda: ops.scatter_rows(src.clone(), src[:nb], starts, 1),
        "relayout_rows": lambda: ops.relayout_rows(src.clone(), _src(seed=1), starts, 1),
        "pack_quant_rows": lambda: ops.pack_quant_rows(src, starts, 1, "int8"),
        "dequant_scatter_rows": lambda: ops.dequant_scatter_rows(src.clone(), q, s, starts, 1),
    }


ENTRIES = sorted(_entries([0]))


@pytest.mark.parametrize("entry", ENTRIES)
@pytest.mark.parametrize("form", sorted(NON_INTEGER))
def test_a_non_integer_start_is_refused_naming_it(form, entry):
    with pytest.raises(ValueError, match=r"start 1\.5 is not an integer") as e:
        _entries(NON_INTEGER[form]())[entry]()
    assert entry in str(e.value)


@pytest.mark.parametrize("form", ["list_of_one", "list_of_many", "tuple", "numpy_float", "tensor_float"])
def test_row_starts_refuses_every_form(form):
    with pytest.raises(ValueError, match="1.5"):
        ref.row_starts(NON_INTEGER[form](), 1, ROWS, "row_starts")


def test_integral_floats_and_other_objects_are_refused_too():
    """A float is refused even where its value is whole, and so is any item
    that is not an integer; an integer past int64 is named as such."""
    for starts, named in (([2.0], "2.0"), ([0, 2.0], "2.0"), (np.array([2.0]), "2.0"), ([0, "3"], "'3'"),
                          ([0, None], "None"), ((0, np.float64(3.0)), "3.0")):
        with pytest.raises(ValueError, match=re.escape(named)):
            ops.pack_rows(_src(), starts, 1)
    for starts in ([2**70], [0, 2**70], np.array([2**70], dtype=object)):
        with pytest.raises(ValueError, match="past int64"):
            ops.pack_rows(_src(), starts, 1)


@pytest.mark.parametrize("form", sorted(INTEGER))
def test_integer_forms_pass_and_equal_the_jax_references(form):
    """Every integer form (and the empty sequence) goes through, with the
    rows and tiles of the JAX references."""
    starts = INTEGER[form]()
    as_np = np.asarray(starts, dtype=np.int32).reshape(-1)
    src = _src()
    js = jnp.asarray(src.numpy())
    got = ops.pack_rows(src, starts, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_ref.pack_rows_ref(js, jnp.asarray(as_np), 1)))
    q, s = ops.pack_quant_rows(src, starts, 1, "int8")
    q_j, s_j = jax_ref.pack_quant_rows_ref(js, jnp.asarray(as_np), 1, "int8")
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_j))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_j))
    for name, call in _entries(starts).items():
        call()  # each entry takes the form


def test_the_list_entries_refusal_codes_match_the_shared_header():
    """csrc/row_tables.cuh names the list reader's codes, clears the Python
    error of a non-integer item, and every list entry returns the codes
    that the wrappers turn into the refusal."""
    header = (CSRC / "row_tables.cuh").read_text()
    codes = dict(re.findall(r"constexpr int (kStartOutside|kNotInteger) = (-?\d+);", header))
    assert int(codes["kStartOutside"]) == rp._START_OUTSIDE == rq._START_OUTSIDE
    assert int(codes["kNotInteger"]) == rp._NOT_INTEGER == rq._NOT_INTEGER
    reader = header[header.index("inline int read_start_list"):]
    reader = reader[: reader.index("\n}\n")]
    assert "PyErr_Clear" in reader and "kNotInteger" in reader
    assert "kPyError" not in header
    for source, entries in (("reshard_pack.cu", ["repro_pack_rows_list"]),
                            ("reshard_quant.cu", ["repro_dequant_scatter_rows_list", "repro_pack_quant_rows_list"])):
        body = (CSRC / source).read_text()
        for entry in entries:
            text = body[body.index(f"int {entry}("):]
            assert re.search(r"read_start_list\s*\(", text[: text.index("\n}\n")]), entry
