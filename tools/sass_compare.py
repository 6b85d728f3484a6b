"""Compare builds of a CUDA source at the machine-code level.

Compiles each given ``.cu`` file with the port's nvcc flags
(``kernels/_build.py``) to a cubin, disassembles it with ``cuobjdump
-sass``, and prints for each kernel whose name holds one of ``--kernels``:
its ``ptxas`` registers and spills, its instruction count, its opcode
counts, and, against the first file's build of the same kernel, whether
the instruction stream is the same (addresses and encodings aside) and
which opcode counts differ.  Headers are read from the port's
``kernels/csrc/``.  Needs the CUDA toolkit (nvcc, cuobjdump), not a card.

    python tools/sass_compare.py parent.cu change.cu [...] \\
        [--kernels sphere_megagrad,mesh_megagrad]
"""

from __future__ import annotations

import argparse
import collections
import pathlib
import re
import subprocess
import sys
import tempfile

HERE = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from opencl_ray_tracer_tpu_torch.kernels import _build  # noqa: E402

FLAGS = [f for f in _build.NVCC_FLAGS
         if f not in ("-shared", "-Xcompiler", "-fPIC")]


def kernel_key(mangled: str) -> str:
    """A kernel's name without the file's anonymous-namespace prefix."""
    return mangled.split("_cu_")[-1]


def build(src: pathlib.Path, work: pathlib.Path, index: int) -> dict:
    """key -> {"ptxas": [...], "sass": [instructions]} for src."""
    cubin = work / f"{index}.cubin"
    proc = subprocess.run([_build._nvcc(), *FLAGS, "-cubin", "-I",
                           str(_build.CSRC), "-o", str(cubin), str(src)],
                          capture_output=True, text=True, check=True)
    out, entry = {}, ""
    for ln in (proc.stdout + proc.stderr).splitlines():
        if "Compiling entry function" in ln:
            entry = kernel_key(ln.split("'")[1])
        elif "Function properties for" in ln:
            entry = kernel_key(ln.split("for ", 1)[1].strip())
        elif "registers" in ln or "spill" in ln:
            out.setdefault(entry, {"ptxas": [], "sass": []})
            line = ln.split(":", 1)[-1].strip()
            if line not in out[entry]["ptxas"]:
                out[entry]["ptxas"].append(line)
    cuobjdump = pathlib.Path(_build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(cubin)],
                          capture_output=True, text=True, check=True).stdout
    cur = None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            cur = kernel_key(m.group(1))
            out.setdefault(cur, {"ptxas": [], "sass": []})
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", ln)
        if cur and m:
            out[cur]["sass"].append(re.sub(r"0x[0-9a-f]+", "X", m.group(1)))
    return out


def opcodes(sass: list) -> collections.Counter:
    ops = collections.Counter()
    for ins in sass:
        m = re.match(r"(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", ins)
        if m:
            ops[m.group(1)] += 1
    return ops


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("sources", nargs="+", type=pathlib.Path)
    ap.add_argument("--kernels", default="sphere_megagrad,mesh_megagrad")
    args = ap.parse_args()
    wanted = args.kernels.split(",")
    with tempfile.TemporaryDirectory() as tmp:
        builds = [build(src.resolve(), pathlib.Path(tmp), i)
                  for i, src in enumerate(args.sources)]
    base = builds[0]
    for src, b in zip(args.sources, builds):
        print(f"== {src}")
        for key in sorted(k for k in b if any(w in k for w in wanted)):
            ops = opcodes(b[key]["sass"])
            print(f"  {key}: {len(b[key]['sass'])} instructions; "
                  + "; ".join(b[key]["ptxas"]))
            if b is base:
                print("    opcodes", dict(sorted(ops.items())))
                continue
            if key not in base:
                print("    absent from the first")
                continue
            ref = base[key]["sass"]
            diff = {op: n for op, n in (ops - opcodes(ref)).items()}
            diff.update({op: -n for op, n in (opcodes(ref) - ops).items()})
            same = b[key]["sass"] == ref
            print("    same instructions as the first" if same else
                  "    opcode counts against the first "
                  + str(dict(sorted(diff.items(), key=lambda x: -abs(x[1])))))


if __name__ == "__main__":
    main()
