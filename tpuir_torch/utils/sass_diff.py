"""Compare the SASS of the kernels two trees compile, function by function.

    python tpuir_torch/utils/sass_diff.py --tree DIR [--match gemm_kernel] [--out FILE]

On the machine with the card (it needs nvcc and cuobjdump): builds this
tree's kernels and those of the checkout at DIR (the parent commit unpacked
under ``build/``, say), each with its own ``ops/_kernels.py`` in a process of
its own, then runs ``cuobjdump -sass`` on each source's object and compares
every function whose mangled name contains ``--match`` (a regular
expression) source by source: the same text, another text, or in one tree
only. A change to a shared header (``csrc/tc_gemm.cuh``) leaves the
instances it does not mean to change identical. One line a differing or
unpaired function, then a summary line; ``--out`` writes both trees' SASS
of the matched functions.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

_BUILD = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
from tpuir_torch.ops import _kernels
_kernels.build()
print(json.dumps({s.stem: str(_kernels.object_path(s)) for s in _kernels._sources()}))
"""


def objects(tree: str) -> dict:
    """{source stem: its object path} of the tree at ``tree``, built."""
    res = subprocess.run([sys.executable, "-c", _BUILD, os.path.abspath(tree)],
                         capture_output=True, text=True, check=True)
    return json.loads(res.stdout.strip().splitlines()[-1])


# nvcc names a source's anonymous namespace after a hash of the source, so
# that the same instance in two trees whose source differs has two names
_ANON = re.compile(r"\d+_GLOBAL__N__[0-9a-f]+_\d+_\w+?_cu_[0-9a-f]{8}")


def functions(obj: str) -> dict:
    """{mangled name: SASS text} of an object's device functions, the
    anonymous namespace's name made the same in every source, branch labels
    numbered within each function, runs of blanks made one and trailing
    blank lines dropped."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME") or "/usr/local/cuda", "bin", "cuobjdump")
    text = _ANON.sub("12_GLOBAL__N_1", subprocess.run(
        [tool, "-sass", obj], capture_output=True, text=True, check=True).stdout)
    out = {}
    for part in re.split(r"^\s*Function : ", text, flags=re.M)[1:]:
        name, _, body = part.partition("\n")
        # (trailing blank lines depend on where the function falls in the
        # listing, the padding before each encoding on the object's widest
        # instruction)
        out[name.strip()] = _BLANKS.sub(" ", _LABEL.sub(_renumber(), body)).rstrip()
    return out


# cuobjdump numbers branch labels (.L_x_N) across the whole object, so that a
# function added before another renames the other's labels
_LABEL = re.compile(r"\.L_x_\d+")
_BLANKS = re.compile(r"[ \t]+")


def _renumber():
    """A substitution that numbers a function's labels in order of first use."""
    seen = {}
    return lambda m: seen.setdefault(m.group(0), f".L_{len(seen)}")


def compare(tree: str, other: str, match: str, out: str = None) -> dict:
    """{source stem: {"same": n, "differ": [names], "only here": [names],
    "only there": [names]}} over the functions matching ``match``."""
    here, there = objects(tree), objects(other)
    pat = re.compile(match)
    res, dump = {}, []
    for stem in sorted(set(here) | set(there)):
        a = functions(here[stem]) if stem in here else {}
        b = functions(there[stem]) if stem in there else {}
        a = {k: v for k, v in a.items() if pat.search(k)}
        b = {k: v for k, v in b.items() if pat.search(k)}
        if not a and not b:
            continue
        res[stem] = {"same": sum(1 for k in a if k in b and a[k] == b[k]),
                     "differ": sorted(k for k in a if k in b and a[k] != b[k]),
                     "only here": sorted(k for k in a if k not in b),
                     "only there": sorted(k for k in b if k not in a)}
        for k in sorted(set(a) | set(b)):
            dump.append(f"== {stem} {k}\n-- {tree}\n{a.get(k, '')}\n-- {other}\n{b.get(k, '')}\n")
    if out:
        Path(out).parent.mkdir(parents=True, exist_ok=True)
        Path(out).write_text("".join(dump))
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True, help="the other checkout")
    ap.add_argument("--match", default="gemm_kernel",
                    help="a regular expression on the mangled names")
    ap.add_argument("--out", help="write the matched functions' SASS here")
    args = ap.parse_args(argv)
    here = str(Path(__file__).resolve().parents[2])
    res = compare(here, args.tree, args.match, args.out)
    same = differ = alone = 0
    for stem, r in res.items():
        same += r["same"]
        differ += len(r["differ"])
        alone += len(r["only here"]) + len(r["only there"])
        for kind in ("differ", "only here", "only there"):
            for name in r[kind]:
                print(f"{stem}: {kind}: {name}")
        print(f"{stem}: {r['same']} identical, {len(r['differ'])} differ, "
              f"{len(r['only here'])} only in {here}, {len(r['only there'])} only in {args.tree}")
    print(f"sass_diff /{args.match}/: {same} identical, {differ} differ, {alone} in one tree only")
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
