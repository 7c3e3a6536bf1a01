#!/usr/bin/env python3
"""Which kernels two checkouts of the PyTorch/CUDA port compile to the same
machine code: builds each tree's kernel libraries (``ops/_build.build``, in
that tree) and compares the SASS of every kernel the two share, source by
source, with ``cuobjdump -sass`` from the CUDA toolkit. Run it on a machine
with the toolkit, from the root of one checkout:

    python3 scripts/sass_compare.py build/parent .

A kernel is matched by its demangled name without its return type and
parameter list and without trailing ``false`` template arguments
(``c++filt``, else ``cu++filt``): a change that adds a trailing ``bool`` flag defaulting to
false, or appends parameters for the flag's arm, can show that the
instantiations without it compile as before. Prints each tree's build
seconds (every source at once, as ``_build.build`` at first use), then,
per source, the kernels with identical SASS, the ones that differ and the
ones only one tree has.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys
import time

CUDA_BIN = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin")
CUOBJDUMP = os.path.join(CUDA_BIN, "cuobjdump")


def build(tree):
    """{source: library path} of tree's kernels, built there; prints the
    build's seconds."""
    code = ("import json; from hydra_tpu_torch.ops import _build; "
            "_build.build(); print(json.dumps({s: _build.library_path(s) "
            "for s in _build.SOURCES}))")
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-c", code], cwd=tree, check=True,
                         capture_output=True, text=True).stdout
    print(f"{tree}: built in {time.perf_counter() - t0:.1f} s", flush=True)
    return json.loads(out.strip().splitlines()[-1])


def _key(demangled):
    """A demangled kernel name without its return type and parameter list
    (the last top-level parenthesized group), its trailing false template
    arguments dropped (``<4, true, false>`` -> ``<4, true>``, ``<false>``
    -> none)."""
    d = demangled.strip()
    if d.endswith(")"):
        depth = 0
        for i in range(len(d) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(d[i], 0)
            if depth == 0:
                d = d[:i]
                break
    d = d.split(" ", 1)[1] if d.startswith("void ") else d
    for false in ("false", "(bool)0"):
        while d.endswith(f", {false}>"):
            d = d[:-len(f", {false}>")] + ">"
        if d.endswith(f"<{false}>"):
            d = d[:-len(f"<{false}>")]
    return d


def demangle(names):
    """{mangled: key} (_key of the demangled name; c++filt, else
    cu++filt)."""
    filt = next((c for c in (shutil.which("c++filt") or "",
                             os.path.join(CUDA_BIN, "cu++filt"))
                 if c and os.path.exists(c)), None)
    if filt is None:
        return {n: n for n in names}
    out = subprocess.run([filt], input="\n".join(names), capture_output=True,
                         text=True, check=True).stdout.splitlines()
    return {n: _key(d) for n, d in zip(names, out)}


def sass(lib):
    """{kernel key (demangle): SASS lines, addresses and encodings left
    out}."""
    out = subprocess.run([CUOBJDUMP, "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    funcs, name = {}, None
    for ln in out.splitlines():
        m = re.match(r"\s+Function : (\S+)", ln)
        if m:
            name = m.group(1)
            funcs[name] = []
        elif name is not None and "/*" in ln:
            body = re.sub(r"/\*[0-9a-f]{4,}\*/", "", ln).split(";")[0].strip()
            if body:
                funcs[name].append(body)
    keys = demangle(list(funcs))
    return {keys[n]: body for n, body in funcs.items()}


def main(argv) -> int:
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    libs = [build(tree) for tree in argv]
    for source in libs[0]:
        if source not in libs[1]:
            print(f"{source}: only in {argv[0]}")
            continue
        fa, fb = sass(libs[0][source]), sass(libs[1][source])
        shared = [n for n in fa if n in fb]
        differ = [n for n in shared if fa[n] != fb[n]]
        print(f"{source}: {len(shared) - len(differ)} kernels with identical "
              f"SASS, {len(differ)} differ, {len(fa) - len(shared)} only in "
              f"{argv[0]}, {len(fb) - len(shared)} only in {argv[1]}")
        for label, names in (("differs", differ),
                             (f"only in {argv[0]}",
                              [n for n in fa if n not in fb]),
                             (f"only in {argv[1]}",
                              [n for n in fb if n not in fa])):
            for n in names:
                print(f"  {label}: {n}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
