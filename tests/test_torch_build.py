"""The C launchers of streamflow_tpu_torch/csrc against the ctypes argument
types that _build.py gives them: the same names, and for each launcher the
same number of arguments with the same kind (pointer, int, float) in every
place. ctypes converts each argument by its declared type, so a pointer
declared as an int would be cut to 32 bits, and nothing else would notice
before the card faults. CPU only: the sources are read as text."""

import ctypes
import re
from pathlib import Path

import pytest

from streamflow_tpu_torch import _build

CSRC = Path(_build.__file__).resolve().parent / "csrc"
LAUNCHER = re.compile(r'extern\s+"C"\s+int\s+(sf_\w+)\s*\(([^)]*)\)', re.S)


def _launchers():
    """name -> list of parameter declarations, from every csrc/*.cu."""
    found = {}
    for src in sorted(CSRC.glob("*.cu")):
        for name, params in LAUNCHER.findall(src.read_text()):
            assert name not in found, f"{name} defined twice"
            found[name] = [p.strip() for p in params.split(",") if p.strip()]
    return found


def _kind(decl: str):
    """ctypes type a C parameter declaration needs."""
    if "*" in decl:
        return ctypes.c_void_p
    words = decl.replace("const", "").split()
    return {"int": ctypes.c_int, "float": ctypes.c_float}[words[0]]


def test_launcher_names_match_signatures():
    assert sorted(_launchers()) == sorted(_build._SIGNATURES)


@pytest.mark.parametrize("name", sorted(_build._SIGNATURES))
def test_launcher_arguments_match_signature(name):
    params = _launchers()[name]
    declared = _build._SIGNATURES[name]
    assert len(params) == len(declared), (name, params)
    for i, (decl, ctype) in enumerate(zip(params, declared)):
        assert _kind(decl) is ctype, f"{name} argument {i}: {decl!r}"
