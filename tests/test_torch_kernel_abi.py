"""The ctypes boundary of the port's CUDA kernels, checked on the CPU.

Every ``extern "C"`` function in ``ray_tpu_torch/ops/csrc/*.cu`` is parsed
and held against its ``_ARGTYPES`` entry in ``ops/flash_attention.py``,
``ops/int8_matmul.py`` or ``ops/decode_attention.py``: the parameter count and each type (pointer -> c_void_p, int -> c_int, long long
-> c_int64, float -> c_float). A mismatch would truncate a pointer or shift
every later argument on the card, and nothing else here would show it.
Then ``_kernel_operand``'s TMA rules on CPU tensors, and how a launch's
return code becomes an error.
"""

import ctypes
import re
from pathlib import Path

import pytest
import torch

from ray_tpu_torch.ops import decode_attention as da
from ray_tpu_torch.ops import flash_attention as fa
from ray_tpu_torch.ops import int8_matmul as im

CSRC = Path(fa.__file__).resolve().parent / "csrc"
ARGTYPES = {**fa._ARGTYPES, **im._ARGTYPES, **da._ARGTYPES}
_EXTERN = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)\s*\{', re.S)


def _ctype(param: str):
    decl = " ".join(param.split())
    if "*" in decl:
        return ctypes.c_void_p
    words = decl.split()[:-1]  # drop the parameter's name
    words = [w for w in words if w != "const"]
    return {("int",): ctypes.c_int, ("long", "long"): ctypes.c_int64,
            ("float",): ctypes.c_float}[tuple(words)]


def _extern_functions():
    found = {}
    for path in sorted(CSRC.glob("*.cu")):
        for name, params in _EXTERN.findall(path.read_text()):
            found[(path.stem, name)] = [_ctype(p) for p in params.split(",")]
    return found


EXTERN = _extern_functions()


def test_every_extern_function_has_argtypes_and_no_more():
    assert EXTERN, "no extern \"C\" function found under csrc/"
    assert set(EXTERN) == set(ARGTYPES)
    assert ("int8_matmul", "int8_matmul") in EXTERN
    assert ("decode_attention", "decode_attention") in EXTERN


def test_every_source_is_built():
    """Every CUDA source under csrc/ is in build.SOURCES, so chip_smoke.py's
    build compiles it."""
    from ray_tpu_torch.ops import build

    assert set(build.SOURCES.values()) == {p.name for p in
                                           CSRC.glob("*.cu")}


@pytest.mark.parametrize("key", sorted(EXTERN), ids=lambda k: "/".join(k))
def test_argtypes_match_the_c_signature(key):
    want = EXTERN[key]
    got = ARGTYPES[key]
    assert len(got) == len(want), (key, len(got), len(want))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g is w, f"{key} parameter {i}: argtypes {g}, C {w}"


def test_int8_matmul_passes_pointers_and_the_stream_as_pointers():
    """x, q, s, y and the stream are 64-bit pointers; a c_int there would
    cut them to 32 bits."""
    got = im._ARGTYPES[("int8_matmul", "int8_matmul")]
    assert [got[i] for i in (0, 1, 2, 3, 8)] == [ctypes.c_void_p] * 5
    assert got[4:8] == [ctypes.c_int] * 4  # dtype, M, K, N
    # the plan: workspace, split, stages, wgmma_n
    assert got[9:] == [ctypes.c_void_p] + [ctypes.c_int] * 3


def test_the_parser_reads_pointer_and_integer_widths():
    assert _ctype("const void* q") is ctypes.c_void_p
    assert _ctype("const long long* strides") is ctypes.c_void_p
    assert _ctype("long long q_sb") is ctypes.c_int64
    assert _ctype("int causal") is ctypes.c_int
    assert _ctype("float scale") is ctypes.c_float


def _bshd(b=2, s=8, h=2, d=64, dtype=torch.bfloat16):
    return torch.zeros((b, s, h, d), dtype=dtype)


def test_aligned_contiguous_operand_passes_unchanged():
    x = _bshd()
    assert fa._kernel_operand(x) is x


def test_aligned_strided_view_passes_unchanged():
    """[B, H, S, D] seen as [B, S, H, D] (as autograd may hand dO over):
    strides of 16-byte multiples, read in place by the tensor maps."""
    x = torch.zeros((2, 2, 8, 64), dtype=torch.bfloat16).transpose(1, 2)
    assert not x.is_contiguous()
    assert fa._kernel_operand(x) is x


def test_misaligned_base_is_copied():
    flat = torch.zeros(2 * 8 * 2 * 64 + 8, dtype=torch.bfloat16)
    x = flat[1:1 + 2 * 8 * 2 * 64].view(2, 8, 2, 64)
    assert x.data_ptr() % 16 != 0
    y = fa._kernel_operand(x)
    assert y is not x and y.data_ptr() % 16 == 0 and torch.equal(y, x)


def test_stride_not_a_multiple_of_16_bytes_is_copied():
    """Heads 20 bf16 (40 bytes) apart: TMA cannot take that stride."""
    x = torch.zeros((1, 8, 2, 20), dtype=torch.bfloat16)[..., :16]
    assert x.stride(2) * x.element_size() % 16 != 0
    y = fa._kernel_operand(x)
    assert y is not x and y.is_contiguous() and torch.equal(y, x)


def test_zero_stride_is_copied():
    """An expanded tensor (dO of a sum) has stride 0, which a tensor map
    refuses; it is copied."""
    x = torch.ones((), dtype=torch.bfloat16).expand(1, 8, 2, 16)
    y = fa._kernel_operand(x)
    assert y is not x and all(st > 0 for st in y.stride())


def test_fp32_rule_is_in_bytes():
    """fp32 heads 8 floats (32 bytes) apart pass in place; 6 floats (24
    bytes) apart are copied."""
    ok = torch.zeros((1, 8, 2, 8))[..., :4]
    assert fa._kernel_operand(ok) is ok
    bad = torch.zeros((1, 8, 2, 6))[..., :4]
    y = fa._kernel_operand(bad)
    assert y is not bad and torch.equal(y, bad)


@pytest.mark.parametrize("rc,match", [
    (10000, "cuTensorMapEncodeTiled"),
    (20001, "CUresult 1"),
    (700, "CUDA error 700"),
])
def test_return_codes_raise(rc, match):
    with pytest.raises(RuntimeError, match=match):
        fa._check_rc("flash_fwd", rc)


def test_return_code_zero_is_success():
    fa._check_rc("flash_fwd", 0)
