"""SASS instruction counts of the port's kernels, from `cuobjdump -sass`.

Counts, for every kernel of the built library (`_build.lib()`), all its
instructions and the integer multiplies among them: IMAD, IMAD.WIDE,
IMAD.HI and IMUL forms with two factors.  IMAD.MOV, IMAD.SHL, IMAD.IADD and
an IMAD with RZ as a factor are moves, shifts and adds that the compiler
issues on the multiply pipe; they are counted apart.  A loop (a backward branch) is reported with its body, since
a static count is then not the count one thread runs.

It also compiles two forms of the 64 x 64 -> 128-bit product, two forms
of the lazy 128-bit reduction and a whole Goldilocks mulmod
(`goldilocks::mul`) alone, each in a kernel of one load pair and two
stores, and reports each one's instructions beyond a kernel that stores a
and b themselves.

    python -m plonky2_tpu_torch.bench.sass [--library PATH]   # needs nvcc and cuobjdump
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import tempfile

from .. import _build

_FUNC = re.compile(r"Function : (\S+)")
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")
_BRA_TARGET = re.compile(r"0x([0-9a-f]+)")

# The probes: one 128-bit product as `a * b` and `__umul64hi`, and as four
# 32 x 32 -> 64 products with the carries in 64-bit adds; the lazy 128-bit
# reduction with its carries from compares in C, and as goldilocks.cuh has
# it (PTX carry flags); the whole canonical mulmod.
_PROBE = r"""
#include <cstdint>
#include "goldilocks.cuh"

extern "C" __global__ void probe_base(const uint64_t* a, const uint64_t* b, uint64_t* o) {
    const int i = threadIdx.x;
    o[2 * i] = a[i];
    o[2 * i + 1] = b[i];
}

extern "C" __global__ void probe_umul64hi(const uint64_t* a, const uint64_t* b, uint64_t* o) {
    const int i = threadIdx.x;
    o[2 * i] = a[i] * b[i];
    o[2 * i + 1] = __umul64hi(a[i], b[i]);
}

extern "C" __global__ void probe_wide32(const uint64_t* a, const uint64_t* b, uint64_t* o) {
    const int i = threadIdx.x;
    const uint64_t x = a[i], y = b[i];
    const uint32_t x0 = (uint32_t)x, x1 = (uint32_t)(x >> 32);
    const uint32_t y0 = (uint32_t)y, y1 = (uint32_t)(y >> 32);
    const uint64_t p00 = (uint64_t)x0 * y0;
    const uint64_t t = (uint64_t)x0 * y1 + (p00 >> 32);
    const uint64_t u = (uint64_t)x1 * y0 + (t & 0xFFFFFFFFull);
    o[2 * i] = (u << 32) | (p00 & 0xFFFFFFFFull);
    o[2 * i + 1] = (uint64_t)x1 * y1 + (t >> 32) + (u >> 32);
}

extern "C" __global__ void probe_reduce_c(const uint64_t* a, const uint64_t* b, uint64_t* o) {
    const int i = threadIdx.x;
    const uint64_t hi = a[i], lo = b[i], hi_hi = hi >> 32, hi_lo = hi & 0xFFFFFFFFull;
    uint64_t t0 = lo - hi_hi;
    if (lo < hi_hi) t0 -= 0xFFFFFFFFull;
    const uint64_t t1 = (hi_lo << 32) - hi_lo;
    uint64_t s = t0 + t1;
    if (s < t1) s += 0xFFFFFFFFull;
    o[2 * i] = s;
    o[2 * i + 1] = b[i];
}

extern "C" __global__ void probe_reduce_lazy(const uint64_t* a, const uint64_t* b, uint64_t* o) {
    const int i = threadIdx.x;
    o[2 * i] = goldilocks::reduce128_lazy(a[i], b[i]);
    o[2 * i + 1] = b[i];
}

extern "C" __global__ void probe_mulmod(const uint64_t* a, const uint64_t* b, uint64_t* o) {
    const int i = threadIdx.x;
    o[2 * i] = goldilocks::mul(a[i], b[i]);
    o[2 * i + 1] = b[i];
}
"""


def _tool(name: str) -> str:
    nvcc = _build._nvcc()
    path = os.path.join(os.path.dirname(nvcc), name)
    if os.path.exists(path):
        return path
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(f"{name} not found beside {nvcc} or on PATH")
    return found


def _demangle(names: list[str]) -> list[str]:
    cxxfilt = shutil.which("c++filt") or shutil.which("cu++filt")
    if cxxfilt is None:
        return names
    out = subprocess.run([cxxfilt], input="\n".join(names), capture_output=True,
                         text=True, timeout=60)
    lines = out.stdout.splitlines()
    return lines if out.returncode == 0 and len(lines) == len(names) else names


def is_multiply(opcode: str, operands: str = "") -> bool:
    """An IMAD or IMUL form that multiplies: not IMAD.MOV/SHL/IADD, and no
    RZ among the two factors (IMAD.X R, RZ, RZ, R, P is an add with carry)."""
    parts = opcode.split(".")
    if parts[0] not in ("IMAD", "IMUL") or {"MOV", "SHL", "IADD"} & set(parts[1:]):
        return False
    srcs = [x.strip() for x in operands.split(",")]
    factors = [x for x in srcs[1:] if not x.startswith("P") or x.startswith("PT")][:2]
    return "RZ" not in factors


def count(binary: str) -> dict:
    """`parse` of `cuobjdump -sass binary` (a shared library or cubin)."""
    return parse(subprocess.run([_tool("cuobjdump"), "-sass", binary], capture_output=True,
                                text=True, timeout=300, check=True).stdout)


def parse(dump: str) -> dict:
    """{kernel name: {"instructions", "multiplies", "imad_other", "loops",
    "body"}}: "loops" are the backward branches as {"start", "end",
    "instructions", "multiplies"} in the order of their starts; "body" is
    every (address, is a multiply, forward-branch target or None).  The
    trailing self-branch and NOPs are not counted."""
    kernels: dict[str, list] = {}
    insns = None
    for line in dump.splitlines():
        m = _FUNC.search(line)
        if m:
            insns = kernels.setdefault(m.group(1), [])
            continue
        m = _INSN.search(line)
        if m and insns is not None and m.group(2) != "NOP":
            t = _BRA_TARGET.search(m.group(3)) if m.group(2).startswith("BRA") else None
            insns.append((int(m.group(1), 16), m.group(2), int(t.group(1), 16) if t else None,
                          m.group(3)))
    out = {}
    for name, insns in zip(_demangle(list(kernels)), kernels.values()):
        body = [(a, is_multiply(op, args), t) for a, op, t, args in insns if t != a]
        loops = sorted(({"start": t, "end": a, "instructions": sum(t <= x <= a for x, _, _ in body),
                         "multiplies": sum(m for x, m, _ in body if t <= x <= a)}
                        for a, _, t in body if t is not None and t < a), key=lambda lp: lp["start"])
        out[name] = {"instructions": len(body), "multiplies": sum(m for _, m, _ in body),
                     "imad_other": sum(op.startswith("IMAD") and not is_multiply(op, args)
                                       for _, op, _, args in insns),
                     "loops": loops,
                     "body": [(a, m, t if t is not None and t > a else None) for a, m, t in body]}
    return out


def per_thread(c: dict, trips) -> dict:
    """{"instructions", "multiplies"} that one thread runs, given each loop's
    trip count in the order of the loops' starts.  A forward branch that
    skips a whole loop guards a region taken on one trip of the loop around
    it (K1's partial rounds, inside its full-round loop): that region runs
    once, and the trip count of a loop inside it is its total."""
    loops = c["loops"]
    if len(loops) != len(trips):
        raise ValueError(f"{len(loops)} loops, {len(trips)} trip counts")
    once = [(a, t) for a, _, t in c["body"] if t is not None
            and any(a < lp["start"] and lp["end"] < t for lp in loops)]
    totals = {"instructions": 0, "multiplies": 0}
    for a, m, _ in c["body"]:
        runs = 1
        for lp, n in zip(loops, trips):
            inside = lp["start"] <= a <= lp["end"]
            guarded = any(lo < a < hi and lp["start"] < lo and hi <= lp["end"] for lo, hi in once)
            runs *= n if inside and not guarded else 1
        totals["instructions"] += runs
        totals["multiplies"] += runs * m
    return totals


def probes() -> dict:
    """{form: {"instructions", "multiplies"} beyond probe_base} for the two
    128-bit product forms ("umul64hi", "wide32"), the two forms of the lazy
    reduction ("reduce_c", "reduce_lazy") and the mulmod."""
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "probe.cu")
        with open(src, "w") as f:
            f.write(_PROBE)
        cubin = os.path.join(tmp, "probe.cubin")
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS[:-1], "-I", _build.CSRC,
                        "-cubin", "-o", cubin, src], check=True, capture_output=True,
                       timeout=300)
        counts = count(cubin)
    base = counts["probe_base"]
    return {form: {k: counts[f"probe_{form}"][k] - base[k]
                   for k in ("instructions", "multiplies")}
            for form in ("umul64hi", "wide32", "reduce_c", "reduce_lazy", "mulmod")}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--library", help="count this built library instead of "
                        "this checkout's (e.g. another checkout's build/*.so)")
    args = parser.parse_args()
    for name, c in sorted(count(args.library or _build.build()).items()):
        loops = "; ".join(f"loop of {lp['instructions']} ({lp['multiplies']} multiplies)"
                          for lp in c["loops"])
        print(f"{name}: {c['instructions']} instructions, {c['multiplies']} multiplies, "
              f"{c['imad_other']} IMAD moves/shifts/adds" + (f"; {loops}" if loops else ""))
    for form, c in probes().items():
        print(f"probe {form}: {c['instructions']} instructions, {c['multiplies']} multiplies")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
