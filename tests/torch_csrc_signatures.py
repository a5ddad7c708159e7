"""The extern "C" signatures of a kernel source of the port, read from its
text (no nvcc): {name: (restype, [ctypes type of each parameter])}, with
a pointer as c_void_p, int as c_int, long long as c_longlong, float as
c_float and void as None; and the fields of a plain struct it declares.
The tests hold each wrapper's ctypes binding against them."""

import ctypes
import os
import re

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "defensegan_torch", "csrc")
_SCALARS = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
            "float": ctypes.c_float}
_DECL = re.compile(r'extern\s+"C"\s+([\w\s\*]+?)\s*\b(\w+)\s*\(([^)]*)\)',
                   re.S)


def _ctype(decl: str):
    decl = " ".join(decl.replace("const", " ").split())
    if "*" in decl:
        return ctypes.c_void_p
    words = decl.split()
    # a parameter's last word is its name, unless the type stands alone
    for cut in (len(words) - 1, len(words)):
        key = " ".join(words[:cut])
        if key in _SCALARS:
            return _SCALARS[key]
        if key == "void":
            return None
    raise ValueError(f"no ctypes type for {decl!r}")


def c_signatures(source: str) -> dict:
    with open(os.path.join(CSRC, source)) as f:
        text = re.sub(r"//[^\n]*", "", f.read())
    out = {}
    for ret, name, params in _DECL.findall(text):
        params = [p for p in params.split(",") if p.strip()]
        out[name] = (_ctype(ret), [_ctype(p) for p in params])
    return out


def c_struct_fields(source: str, name: str) -> list:
    """[(field, ctypes type)] of `struct name { ... };` in the source,
    in order (one type per declaration, several names allowed)."""
    with open(os.path.join(CSRC, source)) as f:
        text = re.sub(r"//[^\n]*", "", f.read())
    body = re.search(r"struct\s+" + name + r"\s*\{([^}]*)\}", text).group(1)
    out = []
    for decl in body.split(";"):
        words = decl.replace(",", " ").split()
        if not words:
            continue
        kind = "long long" if words[:2] == ["long", "long"] else words[0]
        names = words[2:] if kind == "long long" else words[1:]
        out += [(n, _SCALARS[kind]) for n in names]
    return out
