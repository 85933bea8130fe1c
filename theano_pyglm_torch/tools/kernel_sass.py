#!/usr/bin/env python3
"""The machine code of the fused Poisson-LL kernels of several checkouts,
compared.

Compiles each checkout's ``theano_pyglm_torch/csrc/fused_poisson_ll.cu`` (and
``fused_poisson_ll_wide.cu``, ``fused_poisson_ll_bf16.cu``, ``fused_ll_vg_chains.cu`` and
``fused_ll_chains.cu`` where the checkout has them) to cubins with this checkout's nvcc flags, and prints for
each kernel (K1, K2, their wide-U instances K1-wide and K2-wide (one line
each of their m-tile counts), K3-fwd / K3-vg and the four K4 where the checkout has
them, from whichever source holds them) its registers, stack and
instruction count, and how many lines of its SASS differ from the first
checkout's, once the addresses, the encodings and the kernel parameters'
constant-bank offsets are masked (a new kernel parameter moves every later
offset). Writes each masked listing, and each difference from the first
checkout, under ``--out``. Run from the repository root on the GPU machine
(it needs nvcc, cuobjdump and cu++filt, no card):

    python3 theano_pyglm_torch/tools/kernel_sass.py DIR [DIR ...] [--out results/sass]
"""

import argparse
import difflib
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, REPO)

from theano_pyglm_torch.ops import cuda_loader  # noqa: E402

# fused_ll_tiles<kGrad> (one-chain template) or fused_ll_tiles<kGrad, kChains>,
# the bf16 design's fused_ll_bf16_tiles<kGrad[, kChains]> (a bool argument
# reads "true" or "(bool)1"), the chain value-and-gradient pair's
# vg_chains_tiles<float> (K3-vg) and <unsigned short> (K4-vg-chains), and
# the four chain kernels' chains_tiles<X, kGrad>
_TEMPLATE = re.compile(r"fused_ll(_bf16)?_tiles<([^,>]+)(?:, ?([^>]+))?>")
_CHAINS = re.compile(r"(?:vg_)?chains_tiles<([^,>]+)(?:, ?([^>]+))?>")
# K1/K2's wide-U instance: fused_ll_wide_tiles<kGrad, kMI>
_WIDE = re.compile(r"fused_ll_wide_tiles<([^,>]+), ?(?:\(int\))?([0-9]+)>")
_SOURCES = ("fused_poisson_ll.cu", "fused_poisson_ll_wide.cu", "fused_poisson_ll_bf16.cu", "fused_ll_vg_chains.cu",
            "fused_ll_chains.cu")
_TRUE = ("true", "(bool)1")
_MASKS = [
    (re.compile(r"/\*[0-9a-f]{4,}\*/"), ""),  # the instruction's address
    (re.compile(r"/\* 0x[0-9a-f]+ \*/"), ""),  # its encoding
    (re.compile(r"c\[0x0\]\[0x[0-9a-f]+\]"), "c[0x0][P]"),  # a kernel parameter's offset
]


def _kernel(demangled: str):
    m = _WIDE.search(demangled)
    if m is not None:
        return f"K{2 if m.group(1) in _TRUE else 1}-wide (m-tiles {m.group(2)})"
    m = _CHAINS.search(demangled)
    if m is not None:
        grad = m.group(2) is None or m.group(2) in _TRUE  # vg_chains_tiles<X>: gradients
        return ("K3" if m.group(1) == "float" else "K4") + ("-vg" if grad else "-fwd") + \
            ("" if m.group(1) == "float" else "-chains")
    m = _TEMPLATE.search(demangled)
    if m is None:
        return None
    grad, chains = (m.group(i) in _TRUE for i in (2, 3))
    if m.group(1):
        return f"K4-{'vg' if grad else 'fwd'}{'-chains' if chains else ''}"
    return ("K3-vg" if grad else "K3-fwd") if chains else ("K2" if grad else "K1")


def _tool(name: str) -> str:
    return os.path.join(os.path.dirname(cuda_loader._nvcc()), name)


def _demangle(names):
    out = subprocess.run([_tool("cu++filt")], input="\n".join(names), capture_output=True, text=True,
                         check=True).stdout.splitlines()
    return dict(zip(names, out))


def _tag(tree: str) -> str:
    return os.path.basename(os.path.abspath(tree))


def compile_tree(tree: str, out_dir: str) -> dict:
    """{kernel: {"res": resource line, "sass": masked lines}} of one checkout's sources."""
    kernels = {}
    for name in _SOURCES:
        src = os.path.join(tree, "theano_pyglm_torch", "csrc", name)
        if os.path.exists(src):
            kernels.update(_compile(src, os.path.join(out_dir, f"{_tag(tree)}.{name[:-3]}.cubin")))
    return kernels


def _compile(src: str, cubin: str) -> dict:
    flags = " ".join(cuda_loader.nvcc_flags()).replace("-shared", "").replace("-Xcompiler -fPIC", "").split()
    proc = subprocess.run([cuda_loader._nvcc(), *flags, "-cubin", "-o", cubin, src], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"nvcc failed on {src}:\n{proc.stdout}{proc.stderr}")
    res = subprocess.run([_tool("cuobjdump"), "-res-usage", cubin], capture_output=True, text=True,
                         check=True).stdout
    sass = subprocess.run([_tool("cuobjdump"), "-sass", cubin], capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        if cur is not None and "/*" in line:
            for pat, rep in _MASKS:
                line = pat.sub(rep, line)
            cur.append(" ".join(line.split()))
    names = _demangle(list(funcs))
    usage = {}
    for name, line in re.findall(r"Function (\S+):\n\s*(.*)", res):
        usage[name.rstrip(":")] = line.strip()
    kernels = {}
    for name, lines in funcs.items():
        k = _kernel(names[name])
        if k is not None:
            kernels[k] = {"res": usage.get(name, "?"), "sass": lines}
    return kernels


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("trees", nargs="+", help="checkouts of the repository; the first is the baseline")
    p.add_argument("--out", default=os.path.join(REPO, "results", "sass"))
    args = p.parse_args()
    os.makedirs(args.out, exist_ok=True)
    got = {tree: compile_tree(tree, args.out) for tree in args.trees}
    base = got[args.trees[0]]
    for tree, kernels in got.items():
        tag = _tag(tree)
        for k, v in sorted(kernels.items()):
            with open(os.path.join(args.out, f"{tag}.{k}.sass"), "w") as f:
                f.write("\n".join(v["sass"]) + "\n")
            line = f"{tree}: {k}: {len(v['sass'])} instructions; {v['res']}"
            if tree != args.trees[0] and k in base:
                diff = list(difflib.unified_diff(base[k]["sass"], v["sass"], lineterm="", n=2))
                changed = sum(1 for d in diff if d[:1] in "+-" and d[:3] not in ("+++", "---"))
                line += f"; {changed} lines differ from {args.trees[0]}"
                with open(os.path.join(args.out, f"{tag}.{k}.diff"), "w") as f:
                    f.write("\n".join(diff) + "\n")
                if diff:
                    line += " (first: " + " | ".join(d for d in diff[2:14]) + ")"
            print(line, flush=True)


if __name__ == "__main__":
    main()
