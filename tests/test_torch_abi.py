"""The C interface of the CUDA kernel library against its ctypes binding.

ops/_build.py binds every ``extern "C"`` entry point of
stegotpu_torch/csrc/*.cu by hand (``ARGTYPES``). A parameter list that
differs from the source's would pass wrong pointers on the card while
every CPU test stays green, so each signature is parsed from the source
here and held to its binding: the count of parameters and the kind of
each (a pointer, ``int``, ``long long`` or ``float``). No nvcc, no card.
"""

import ctypes
import re

import pytest

from stegotpu_torch.ops import _build

_ENTRY = re.compile(r"^(int|const char\*)\s+(stegotpu_\w+)\s*\(([^)]*)\)\s*\{",
                    re.MULTILINE)
_KIND = {"int": ctypes.c_int, "long long": ctypes.c_int64,
         "float": ctypes.c_float}


def _extern_c(text: str) -> str:
    """The text of every extern "C" block of a source."""
    return "".join(re.findall(r'extern "C" \{(.*?)\}\s*// extern "C"', text,
                              re.DOTALL))


def _param_type(param: str):
    """The ctypes type of one C parameter ('const void* frames')."""
    if "*" in param:
        return ctypes.c_void_p
    words = param.split()[:-1]  # the type, without the parameter's name
    return _KIND[" ".join(w for w in words if w != "const")]


def entry_points() -> dict[str, tuple[str, list]]:
    """name -> (result type, ctypes parameter types) of every C entry point
    in csrc/*.cu."""
    out = {}
    for src in _build.sources():
        for result, name, params in _ENTRY.findall(_extern_c(src.read_text())):
            assert name not in out, f"{name} defined twice"
            out[name] = (result, [_param_type(p) for p in params.split(",")
                                  if p.strip()])
    return out


ENTRIES = entry_points()


def test_every_entry_point_is_bound_and_every_binding_exists():
    kernels = {n for n, (result, _) in ENTRIES.items() if result == "int"}
    assert kernels == set(_build.ARGTYPES)
    assert ENTRIES["stegotpu_cuda_error_string"] == ("const char*",
                                                     [ctypes.c_int])


@pytest.mark.parametrize("name", sorted(_build.ARGTYPES))
def test_binding_matches_the_source(name):
    result, params = ENTRIES[name]
    assert result == "int"
    assert _build.ARGTYPES[name] == params, name


def test_the_unpack_kernel_is_bound():
    """The wire-order unpack's entry point (csrc/qim_unpack.cu): packed and
    bits pointers, device, B, H, W, num_ac, stripe, rows_pad, the store
    width, then the stream."""
    assert _build.ARGTYPES["stegotpu_qim_unpack_packed"] == [
        ctypes.c_void_p, ctypes.c_void_p, *[ctypes.c_int] * 8,
        ctypes.c_void_p]
    assert ENTRIES["stegotpu_qim_unpack_packed"][1] == \
        _build.ARGTYPES["stegotpu_qim_unpack_packed"]


def test_parser_reads_each_kind():
    text = '''extern "C" {
int stegotpu_x(const void* a, void* b, int c, long long d, float e,
               void* stream) {
  return 0;
}
}  // extern "C"
int stegotpu_outside(int a) { return a; }
'''
    (found,) = _ENTRY.findall(_extern_c(text))
    assert found[1] == "stegotpu_x"
    assert [_param_type(p) for p in found[2].split(",")] == [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
        ctypes.c_float, ctypes.c_void_p]


def test_bind_sets_the_types_of_what_a_library_exports():
    class Fn:
        pass

    class Lib:
        stegotpu_qim_embed_check = Fn()
        stegotpu_cuda_error_string = Fn()

    lib = _build.bind(Lib())
    assert lib.stegotpu_qim_embed_check.argtypes == \
        _build.ARGTYPES["stegotpu_qim_embed_check"]
    assert lib.stegotpu_qim_embed_check.restype is ctypes.c_int
    assert lib.stegotpu_cuda_error_string.restype is ctypes.c_char_p
