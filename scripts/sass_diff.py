"""Compare the machine code (SASS) of one CUDA source in two checkouts,
kernel by kernel.

    python3 scripts/sass_diff.py parent=build/parent change=. \\
        [--source gqsa_gemv] [--match "G..."]

Each checkout's ``src/repro_torch/csrc/<source>.cu`` is compiled by nvcc
with the flags of this checkout's ``kernels/build.py`` (``NVCC_FLAGS``)
into a scratch library under ``build/sass/``; ``cuobjdump -sass`` lists
each kernel's instructions. Prints, for every kernel both libraries hold
(by name, so a template instantiation is matched with its own),
whether its instructions are identical, and the kernels only one of them
holds; ``--match`` keeps the kernels whose demangled name holds that
regular expression. Exit code 0 either way: the result is the report.
"""
from __future__ import annotations

import argparse
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _tool(name: str) -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / name
    return str(cand) if cand.exists() else name


def sass(root: Path, source: str, tag: str) -> dict:
    """{mangled kernel name: its SASS lines} of ``root``'s ``source``."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.build import NVCC_FLAGS
    out = ROOT / "build" / "sass" / f"lib{source}.{tag}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    flags = [f for f in NVCC_FLAGS if f not in ("-Xptxas", "-v")]
    subprocess.run([_tool("nvcc"), *flags, "-o", str(out),
                    str(root / "src" / "repro_torch" / "csrc"
                        / f"{source}.cu")], check=True)
    text = subprocess.run([_tool("cuobjdump"), "-sass", str(out)],
                          check=True, capture_output=True,
                          text=True).stdout
    kernels, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            kernels[name] = []
        elif name is not None and line.strip():
            kernels[name].append(line.strip())
    return kernels


def _anon(name: str) -> str:
    """A mangled name with its anonymous namespace (nvcc names it per
    file: ``<length>_GLOBAL__N__<hash>...``) renamed ``ANON``, so the same
    instantiation of two sources has the same name."""
    m = re.search(r"(\d+)(_GLOBAL__N_)", name)
    if m is None:
        return name
    end = m.start(2) + int(m.group(1))
    return name[:m.start(1)] + "4ANON" + name[end:]


def by_name(kernels: dict) -> dict:
    """The kernels keyed by demangled name (anonymous namespace as
    ``ANON``)."""
    names = [_anon(n) for n in kernels]
    res = subprocess.run(["c++filt"], input="\n".join(names), text=True,
                         capture_output=True)
    lines = res.stdout.splitlines() if res.returncode == 0 else []
    if len(lines) != len(names):
        lines = names
    return dict(zip(lines, kernels.values()))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkouts", nargs=2, help="name=path, twice")
    ap.add_argument("--source", default="gqsa_gemv")
    ap.add_argument("--match", default="")
    args = ap.parse_args()
    (na, pa), (nb, pb) = (c.split("=", 1) for c in args.checkouts)
    a = by_name(sass(Path(pa).resolve(), args.source, na))
    b = by_name(sass(Path(pb).resolve(), args.source, nb))
    keep = [n for n in sorted(set(a) | set(b)) if re.search(args.match, n)]
    same = [n for n in keep if n in a and n in b and a[n] == b[n]]
    differ = [n for n in keep if n in a and n in b and a[n] != b[n]]
    for n in differ:
        print(f"SASS differs: {n} ({len(a[n])} vs {len(b[n])} lines)")
    for n in keep:
        if (n in a) != (n in b):
            print(f"only in {na if n in a else nb}: {n}")
    print(f"RESULT sass {args.source} match={args.match!r}: "
          f"{len(same)} identical, {len(differ)} differ, "
          f"{sum((n in a) != (n in b) for n in keep)} in one checkout only")
    return 0


if __name__ == "__main__":
    sys.exit(main())
