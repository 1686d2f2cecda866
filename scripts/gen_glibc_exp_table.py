"""Write glibc's exp table and constants as a C header.

``feastkit_tpu_torch/ops/csrc/seeded_draw.cu`` decides the ziggurat's
wedge test with glibc's ``exp``, as numpy's draw does on the host. glibc's
``exp`` (``sysdeps/ieee754/dbl-64/e_exp.c``, since glibc 2.28) writes
exp(x) = 2^(k/128) exp(r) and reads 2^(k/128) from a 256-word table: for
each k < 128, H_k, the double nearest 2^(k/128), less k << 45 in its bits,
and T_k, the double nearest 2^(k/128) / H_k - 1. This script computes the
table in exact arithmetic, takes the reduction and polynomial constants as
glibc's ``e_exp_data.c`` gives them, holds both against the ``__exp_data``
of the libm this Python runs on (found by its constants' bytes, where that
libm is glibc's) and writes them to
``feastkit_tpu_torch/ops/csrc/glibc_exp.h``. Run from the root of the
repository:

    python scripts/gen_glibc_exp_table.py [--out PATH]

``tests/test_torch_seeded_draw.py`` holds the committed header against
this script and the host's libm.
"""
from __future__ import annotations

import argparse
import struct
from decimal import Decimal, localcontext
from fractions import Fraction
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "feastkit_tpu_torch" / "ops" / "csrc" / "glibc_exp.h"
TABLE_BITS = 7
# glibc's e_exp_data.c: 128 / ln 2, -ln 2 / 128 in two parts, the four
# last coefficients of exp(r) - 1 and the round-to-integer shift
CONSTANTS = {
    "INVLN2N": float.fromhex("0x1.71547652b82fep0") * 128,
    "NEGLN2HIN": float.fromhex("-0x1.62e42fefa0000p-8"),
    "NEGLN2LON": float.fromhex("-0x1.cf79abc9e3b3ap-47"),
    "C2": float.fromhex("0x1.ffffffffffdbdp-2"),
    "C3": float.fromhex("0x1.555555555543cp-3"),
    "C4": float.fromhex("0x1.55555cf172b91p-5"),
    "C5": float.fromhex("0x1.1111167a4d017p-7"),
    "SHIFT": float.fromhex("0x1.8p52"),
}


def _bits(v: float) -> int:
    return struct.unpack("<Q", struct.pack("<d", v))[0]


def table() -> list:
    """The 256 words: T_k's bits, then H_k's bits less k << 45."""
    n = 1 << TABLE_BITS
    out = []
    with localcontext() as ctx:
        ctx.prec = 60
        for k in range(n):
            exact = Fraction(Decimal(2) ** (Decimal(k) / n))
            hi = float(exact)
            tail = float(exact / Fraction(hi) - 1)
            out += [_bits(tail),
                    (_bits(hi) - (k << (52 - TABLE_BITS))) % (1 << 64)]
    return out


def host_libm() -> Path | None:
    """The libm mapped into this process (CPython's math module links it)."""
    import math  # noqa: F401
    for line in Path("/proc/self/maps").read_text().splitlines():
        path = line.split()[-1]
        if "/libm.so" in path or "/libm-" in path:
            return Path(path)
    return None


def read_libm(path: Path) -> dict | None:
    """{constant: value, "table": words} of the ``__exp_data`` in the libm
    at ``path``, or None where its bytes hold no such data."""
    data = path.read_bytes()
    head = struct.pack("<3d", CONSTANTS["INVLN2N"], CONSTANTS["NEGLN2HIN"],
                       CONSTANTS["NEGLN2LON"])
    at = data.find(head)
    first = struct.pack("<4Q", *table()[:4])
    tab_at = data.find(first)
    if at < 0 or tab_at < 0:
        return None
    # the layout glibc 2.28 and later give the struct's first fields
    out = dict(zip(("INVLN2N", "NEGLN2HIN", "NEGLN2LON", "C2", "C3", "C4",
                    "C5", "SHIFT"), struct.unpack_from("<8d", data, at)))
    out["table"] = list(struct.unpack_from("<256Q", data, tab_at))
    return out


def render(words: list) -> str:
    lines = ["// glibc's exp table and constants (__exp_data of",
             "// sysdeps/ieee754/dbl-64/e_exp_data.c), written by",
             "// scripts/gen_glibc_exp_table.py. Do not edit.", "",
             "#pragma once", "",
             "// the table's storage: a CUDA source defines it as",
             "// `static __device__` before it includes this file",
             "#ifndef GLIBC_EXP_STORAGE",
             "#define GLIBC_EXP_STORAGE static",
             "#endif", ""]
    lines += [f"#define GLIBC_EXP_{name} {float.hex(v)}"
              for name, v in CONSTANTS.items()]
    lines += ["", "GLIBC_EXP_STORAGE const unsigned long long "
              f"glibc_exp_tab[{len(words)}] = {{"]
    for i in range(0, len(words), 4):
        lines.append("    " + ", ".join(f"0x{w:016x}ULL"
                                        for w in words[i:i + 4]) + ",")
    lines.append("};")
    return "\n".join(lines) + "\n"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args()
    words = table()
    libm = host_libm()
    found = read_libm(libm) if libm else None
    if found is None:
        print(f"no glibc __exp_data found in {libm}: not checked")
    elif found != dict(CONSTANTS, table=words):
        raise SystemExit(f"{libm}'s __exp_data differs from glibc 2.28's")
    args.out.write_text(render(words))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
