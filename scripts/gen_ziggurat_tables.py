"""Write numpy's ziggurat tables for the normal draw as a C header.

``feastkit_tpu_torch/ops/csrc/seeded_draw.cu`` draws numpy's
``Generator.standard_normal`` bit for bit on the card. The draw reads three
256-entry tables (``ki_double``, ``wi_double``, ``fi_double``). This script
reads them out of the installed numpy's ``numpy/random/lib/libnpyrandom.a``
(the ``.rodata`` symbols of its member ``..._distributions.c.o``, found by
name in the member's ELF symbol table, so numpy's build layout does not
matter) and writes them, with numpy's licence and the two constants of the
tail, to ``feastkit_tpu_torch/ops/csrc/npy_ziggurat.h``. Nothing is
downloaded. Run from the root of the repository:

    python scripts/gen_ziggurat_tables.py [--out PATH]

``tests/test_torch_seeded_draw.py`` holds the committed header against the
installed numpy's own draws.
"""
from __future__ import annotations

import argparse
import struct
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
OUT = ROOT / "feastkit_tpu_torch" / "ops" / "csrc" / "npy_ziggurat.h"
SYMBOLS = ("ki_double", "wi_double", "fi_double")
# numpy/random/src/distributions/ziggurat_constants.h: the start of the
# tail and its inverse, as numpy's source writes them
NOR_R = "3.6541528853610087963519472518"
NOR_INV_R = "0.27366123732975827203338247596"


def archive_members(data: bytes):
    """(name, bytes) of each member of a System V / GNU ``ar`` archive."""
    if not data.startswith(b"!<arch>\n"):
        raise ValueError("not an ar archive")
    pos, names = 8, b""
    while pos + 60 <= len(data):
        head = data[pos:pos + 60]
        name = head[:16].decode().strip()
        size = int(head[48:58].decode().strip())
        body = data[pos + 60:pos + 60 + size]
        pos += 60 + size + (size & 1)
        if name == "//":                    # the GNU long-name table
            names = body
            continue
        if name.startswith("/") and name[1:].isdigit():
            start = int(name[1:])
            name = names[start:names.index(b"/\n", start)].decode()
        yield name.rstrip("/"), body


def elf_symbols(obj: bytes) -> dict:
    """name -> bytes of each sized data symbol of a 64-bit ELF object."""
    if obj[:4] != b"\x7fELF" or obj[4] != 2 or obj[5] != 1:
        raise ValueError("not a little-endian 64-bit ELF object")
    shoff, = struct.unpack_from("<Q", obj, 0x28)
    shentsize, shnum = struct.unpack_from("<HH", obj, 0x3A)
    sections = [struct.unpack_from("<IIQQQQIIQQ", obj, shoff + i * shentsize)
                for i in range(shnum)]
    out = {}
    for sh in sections:
        if sh[1] != 2:                       # SHT_SYMTAB
            continue
        strtab = sections[sh[6]]
        for k in range(sh[5] // sh[9]):
            st_name, _, _, st_shndx, value, size = struct.unpack_from(
                "<IBBHQQ", obj, sh[4] + k * sh[9])
            if not size or not 0 < st_shndx < shnum:
                continue
            start = strtab[4] + st_name
            name = obj[start:obj.index(b"\0", start)].decode()
            base = sections[st_shndx][4]
            out[name] = obj[base + value:base + value + size]
    return out


def read_tables(archive: Path) -> dict:
    for name, body in archive_members(archive.read_bytes()):
        if name.endswith("distributions.c.o"):
            syms = elf_symbols(body)
            if all(s in syms and len(syms[s]) == 2048 for s in SYMBOLS):
                return {s: syms[s] for s in SYMBOLS}
    raise RuntimeError(f"no member of {archive} holds {SYMBOLS}")


def numpy_licence() -> str:
    import importlib.metadata as md
    for f in md.distribution("numpy").files or ():
        if f.name in ("LICENSE.txt", "LICENSE"):
            text = Path(f.locate()).read_text()
            return text.split("\n----")[0].strip()
    raise RuntimeError("the installed numpy carries no LICENSE.txt")


def render(tables: dict) -> str:
    ki = struct.unpack("<256Q", tables["ki_double"])
    wi = struct.unpack("<256d", tables["wi_double"])
    fi = struct.unpack("<256d", tables["fi_double"])
    lines = ["// numpy's ziggurat tables of the normal draw (ki_double,",
             "// wi_double, fi_double of numpy/random/src/distributions), read",
             f"// from numpy {np.__version__}'s libnpyrandom.a by",
             "// scripts/gen_ziggurat_tables.py. Do not edit.",
             "//"]
    lines += ["// " + line if line else "//"
              for line in numpy_licence().splitlines()]
    lines += ["", "#pragma once", "",
              "// the tables' storage: a CUDA source defines it as",
              "// `static __device__` before it includes this file",
              "#ifndef NPY_ZIG_STORAGE",
              "#define NPY_ZIG_STORAGE static",
              "#endif", "",
              f"#define NPY_ZIGGURAT_NOR_R {NOR_R}",
              f"#define NPY_ZIGGURAT_NOR_INV_R {NOR_INV_R}", ""]

    def block(ctype, name, items):
        out = [f"NPY_ZIG_STORAGE const {ctype} {name}[256] = {{"]
        for i in range(0, 256, 4):
            out.append("    " + ", ".join(items[i:i + 4]) + ",")
        out.append("};")
        return out
    lines += block("unsigned long long", "npy_zig_ki",
                   [f"0x{v:016x}ULL" for v in ki])
    lines += block("double", "npy_zig_wi", [float.hex(v) for v in wi])
    lines += block("double", "npy_zig_fi", [float.hex(v) for v in fi])
    return "\n".join(lines) + "\n"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=OUT)
    args = ap.parse_args()
    archive = Path(np.__file__).parent / "random" / "lib" / "libnpyrandom.a"
    args.out.write_text(render(read_tables(archive)))
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
