"""Environment diagnostics of the port: `python -m deep_staple_torch.doctor`.

The port's counterpart of `deep_staple_tpu/doctor.py`, for PyTorch and CUDA
on an NVIDIA card. It checks what fails in deployment, in dependency order,
and never hangs: each probe of the card, the compiler and the kernel build
runs in a subprocess with `--timeout`, so a wedged driver or a stuck nvcc
cannot block it.

Checks:
  1. versions: Python, torch and the CUDA it was built for, numpy, scipy
     (JAX is not needed);
  2. the card: `torch.cuda` in a subprocess (available, name, count), and
     nvidia-smi's name and power limit;
  3. `nvcc` (`ops/cuda_build.py` finds it as the kernel build does) and its
     version;
  4. the kernel build: `ops/cuda_build.build_libraries` builds or finds the
     three `csrc/*.cu` for `sm_90a` in `build/kernels/`, and each library
     loads;
  5. the mesh probe, the counterpart of the JAX doctor's virtual-mesh
     check (`deep_staple_tpu/doctor.py:147-167`): two gloo ranks on the CPU,
     started in a subprocess, all-reduce a tensor and check the sum, which
     is what the port's data parallelism (`parallel/`) needs of
     `torch.distributed`;
  6. the JAX checkpoint reader and writer, in place of the JAX doctor's
     orbax import (`deep_staple_tpu/doctor.py:96-100`): a small tree
     through `train/orbax_io.write_orbax` and `read_orbax`, and one zstd
     frame (Huffman literals, FSE sequences, a content checksum) through
     `train/zstd.decompress`;
  7. optional: the native C++ NIfTI library (`data/native_io.py`) and
     matplotlib / PIL (the figures); these only warn.

The JAX doctor's compile-cache check has no counterpart (nvcc's libraries in
`build/kernels/` play that part, `core/cache.py` is not ported by design).

Exit code 0 only when the versions, the card, nvcc, the kernel build, the
mesh probe and the checkpoint check all pass. Without a card it exits 1 and says that only the `--device cpu` paths
are usable: the port's entry points raise without CUDA (`core/device.py`).
"""

from __future__ import annotations

import datetime
import os
import subprocess
import sys
import tempfile
from pathlib import Path

_REPO = Path(__file__).resolve().parent.parent

OK, WARN, FAIL = "ok", "warn", "FAIL"


def _report(name: str, status: str, detail: str = "") -> bool:
    pad = " " * max(1, 34 - len(name))
    print(f"  {name}{pad}[{status}]  {detail}".rstrip())
    return status != FAIL


def _subprocess_probe(code: str, timeout: int):
    """Run a python snippet in a fresh interpreter from the repository root;
    -> (status, output): 'ok' (rc 0), 'error' (another rc) or 'timeout'."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(_REPO)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    try:
        proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              timeout=timeout, env=env, cwd=str(_REPO))
    except subprocess.TimeoutExpired:
        return "timeout", ""
    out = (proc.stdout + proc.stderr).strip()
    return ("ok" if proc.returncode == 0 else "error"), out


def _last_line(out: str) -> str:
    lines = [line for line in out.splitlines() if line.strip()]
    return lines[-1] if lines else ""


def _tagged(out: str, tag: str) -> str:
    lines = [line for line in out.splitlines() if line.startswith(tag + " ")]
    return lines[-1][len(tag) + 1:] if lines else ""


def check_versions() -> bool:
    good = _report("python", OK, sys.version.split()[0])
    try:
        import torch

        good &= _report("torch / CUDA build", OK,
                        f"{torch.__version__} / {torch.version.cuda or 'none (CPU build)'}")
    except ImportError as e:
        good &= _report("torch / CUDA build", FAIL, repr(e))
    for mod in ("numpy", "scipy"):
        try:
            m = __import__(mod)
            good &= _report(mod, OK, getattr(m, "__version__", "?"))
        except ImportError as e:
            good &= _report(mod, FAIL, repr(e))
    return good


def check_card(timeout: int) -> bool:
    code = ("import torch; n = torch.cuda.device_count() if torch.cuda.is_available() else 0; "
            "print('CARD', n, torch.cuda.get_device_name(0) if n else '-')")
    status, out = _subprocess_probe(code, timeout)
    if status == "timeout":
        return _report("CUDA card", FAIL, f"torch.cuda hung >{timeout}s (driver wedged?)")
    if status == "error":
        return _report("CUDA card", FAIL, _last_line(out))
    n, _, name = _tagged(out, "CARD").partition(" ")
    if n in ("", "0"):
        return _report("CUDA card", FAIL, "torch.cuda.is_available() is False")
    return _report("CUDA card", OK, f"{name}, {n} device(s)")


def check_power_limit(timeout: int) -> bool:
    cmd = ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    except FileNotFoundError:
        return _report("nvidia-smi name, power limit", WARN, "nvidia-smi not found")
    except subprocess.TimeoutExpired:
        return _report("nvidia-smi name, power limit", WARN, f"hung >{timeout}s")
    if proc.returncode != 0:
        return _report("nvidia-smi name, power limit", WARN, proc.stderr.strip()[-200:])
    return _report("nvidia-smi name, power limit", OK,
                   "; ".join(proc.stdout.strip().splitlines()))


def check_nvcc(timeout: int) -> bool:
    from .ops.cuda_build import _nvcc

    try:
        nvcc = _nvcc()
    except RuntimeError as e:
        return _report("nvcc", FAIL, str(e))
    try:
        proc = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=timeout)
    except subprocess.TimeoutExpired:
        return _report("nvcc", FAIL, f"{nvcc} --version hung >{timeout}s")
    release = [line for line in proc.stdout.splitlines() if "release" in line]
    if proc.returncode != 0 or not release:
        return _report("nvcc", FAIL, (proc.stdout + proc.stderr).strip()[-200:])
    return _report("nvcc", OK, f"{nvcc}: {release[-1].strip()}")


def check_kernel_build(timeout: int) -> bool:
    code = ("import ctypes; from deep_staple_torch.ops.cuda_build import SOURCES, "
            "build_libraries; built = build_libraries(); "
            "[ctypes.CDLL(str(built[n][0])) for n in SOURCES]; "
            "print('BUILT', ' '.join(built[n][0].name for n in SOURCES))")
    status, out = _subprocess_probe(code, timeout)
    if status == "timeout":
        return _report("kernel build (sm_90a)", FAIL, f"nvcc did not finish in {timeout}s")
    if status == "error":
        return _report("kernel build (sm_90a)", FAIL, _last_line(out))
    return _report("kernel build (sm_90a)", OK, f"build/kernels/: {_tagged(out, 'BUILT')}")


def _gloo_rank(rank: int, store: str) -> None:
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}", world_size=2, rank=rank,
                            timeout=datetime.timedelta(seconds=60))
    t = torch.tensor([float(rank + 1)])
    dist.all_reduce(t)
    dist.destroy_process_group()
    if float(t) != 3.0:
        raise SystemExit(f"rank {rank}: all_reduce gave {float(t)}, not 3.0")


def gloo_probe() -> None:
    """Two gloo ranks (spawned processes) all-reduce 1 and 2; exits non-zero
    unless both see 3."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="doctor_gloo_") as tmp:
        procs = [ctx.Process(target=_gloo_rank, args=(r, os.path.join(tmp, "store")), daemon=True)
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0, 0]:
        raise SystemExit(f"gloo ranks exited with {codes}")
    print("MESH 2 gloo ranks on the CPU: all_reduce 1 + 2 = 3")


def check_mesh(timeout: int) -> bool:
    status, out = _subprocess_probe(
        "from deep_staple_torch.doctor import gloo_probe; gloo_probe()", timeout)
    if status == "timeout":
        return _report("2-rank gloo process group", FAIL, f"hung >{timeout}s")
    if status == "error":
        return _report("2-rank gloo process group", FAIL, _last_line(out))
    return _report("2-rank gloo process group", OK, _tagged(out, "MESH"))


# zstd level 19 of _ZSTD_TEXT, with its content checksum.
_ZSTD_FRAME = bytes.fromhex(
    "28b52ffd64a700c5030032481a1960770e50b1e728cb6a1b23ec1ef55cf2ff282c088c41"
    "90c20317283bc9d8c5f4489350db5c2375b9551461ca618d59b51dfd55babd23c3fa27f7"
    "74921874efdeed01e537e59de230980fb4ca38adc93174d716ea790ab0b4935beb0fb19c"
    "613d7dcbfddad33a432703001710a32aa8f082c6525193d9e7d1")
_ZSTD_TEXT = ("The port reads the JAX package's orbax checkpoints: OCDBT nodes, zarr chunks and "
              "their zstd frames, with Huffman literals and FSE sequences. ") * 3


def check_orbax() -> bool:
    import numpy as np
    import torch

    from .train import zstd
    from .train.orbax_io import read_orbax, write_orbax

    name = "orbax reader / writer, zstd"
    tree = {"step": np.array(3, np.int32), "params": {"w": np.arange(6, dtype=np.float32)},
            "bf16": torch.ones(2, 3, dtype=torch.bfloat16), "opt": {"0": {}, "1": {}},
            "dp_params": None}
    try:
        with tempfile.TemporaryDirectory() as d:
            write_orbax(Path(d) / "state.orbax", tree)
            back = read_orbax(Path(d) / "state.orbax")
        ok = (int(back["step"]) == 3 and back["params"]["w"].tolist() == list(range(6))
              and torch.equal(back["bf16"], tree["bf16"]) and back["opt"] == {"0": {}, "1": {}}
              and back["dp_params"] is None)
        ok &= zstd.decompress(_ZSTD_FRAME) == _ZSTD_TEXT.encode()
    except (OSError, ValueError) as e:
        return _report(name, FAIL, repr(e))
    if not ok:
        return _report(name, FAIL, "round trip or frame decode differs")
    return _report(name, OK, f"round trip; a {len(_ZSTD_FRAME)}-byte frame decoded")


def check_native() -> bool:
    from .data import native_io

    if native_io._find_lib() is None:
        if os.environ.get("DEEPSTAPLE_NO_AUTOBUILD"):
            why = "autobuild opted out via DEEPSTAPLE_NO_AUTOBUILD=1"
        else:
            why = native_io.LAST_AUTOBUILD_ERROR or "autobuild failed (no error recorded)"
        _report("native C++ lib", WARN, f"absent: {why} (the NIfTI reader falls back to Python)")
    else:
        _report("native C++ lib", OK, native_io.reader_name())
    return True


def check_figures() -> bool:
    missing = []
    for mod in ("matplotlib", "PIL"):
        try:
            __import__(mod)
        except ImportError:
            missing.append(mod)
    if missing:
        _report("matplotlib / PIL (figures)", WARN,
                f"{', '.join(missing)} missing: --plot-dir, save_dp_figures and do_plot raise")
    else:
        _report("matplotlib / PIL (figures)", OK, "")
    return True


def main(argv=None) -> int:
    import argparse

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--timeout", type=int, default=600,
                   help="per-probe subprocess timeout in seconds (the kernel build's included)")
    args = p.parse_args(argv)

    print("deep_staple_torch doctor")
    print(f"  repo: {_REPO}")
    good = check_versions()
    card = check_card(args.timeout)
    check_power_limit(args.timeout)
    nvcc = check_nvcc(args.timeout)
    build = check_kernel_build(args.timeout)
    mesh = check_mesh(args.timeout)
    good &= check_orbax()
    check_native()
    check_figures()
    if not card:
        print("summary: no CUDA card; only the --device cpu paths are usable"
              + ("" if good else ", and the versions above FAIL"))
        return 1
    good &= nvcc and build and mesh
    print("summary: " + ("all checks passed" if good else "FAILURES above"))
    return 0 if good else 1


if __name__ == "__main__":
    sys.exit(main())
