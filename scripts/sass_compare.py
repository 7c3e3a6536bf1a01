#!/usr/bin/env python3
"""Which kernels two checkouts of the PyTorch/CUDA port compile to the same
machine code: builds each tree's kernel libraries (``ops/_build.build``, in
that tree) and compares the SASS of every kernel the two share, source by
source, with ``cuobjdump -sass`` from the CUDA toolkit. Run it on a machine
with the toolkit, from the root of one checkout:

    python3 scripts/sass_compare.py build/parent .

A kernel whose template gained a trailing ``bool`` argument that defaults
to false is matched to its old name (``...Lb0EEEv`` -> ``...EEv``), so a
change that adds such a flag can show that the instantiations without it
compile as before. Prints, per source, the kernels with identical SASS, the
ones that differ and the ones only one tree has.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

CUOBJDUMP = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                         "bin", "cuobjdump")


def build(tree):
    """{source: library path} of tree's kernels, built there."""
    code = ("import json; from hydra_tpu_torch.ops import _build; "
            "_build.build(); print(json.dumps({s: _build.library_path(s) "
            "for s in _build.SOURCES}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tree, check=True,
                         capture_output=True, text=True).stdout
    return json.loads(out.strip().splitlines()[-1])


def sass(lib):
    """{kernel name (a false trailing flag dropped): SASS lines, addresses
    and encodings left out}."""
    out = subprocess.run([CUOBJDUMP, "-sass", lib], capture_output=True,
                         text=True, check=True).stdout
    funcs, name = {}, None
    for ln in out.splitlines():
        m = re.match(r"\s+Function : (\S+)", ln)
        if m:
            name = m.group(1).replace("Lb0EEEv", "EEv")
            funcs[name] = []
        elif name is not None and "/*" in ln:
            body = re.sub(r"/\*[0-9a-f]{4,}\*/", "", ln).split(";")[0].strip()
            if body:
                funcs[name].append(body)
    return funcs


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
