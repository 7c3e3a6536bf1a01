"""Launch hydra_tpu_torch as D ranks on one host: one process a marker shard.

The launcher of the PyTorch port, beside the JAX package's
``scripts/run_multiprocess.py`` (the analogue of the reference's
``srun``/mvapich launch, main.cpp:20 MPI_Init). It starts D processes of
``python -m hydra_tpu_torch.cli`` with torchrun's environment on
localhost (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT); each
joins the process group (``hydra_tpu_torch/parallel/distributed.py``),
reads only its shard's .bed rows, and only rank 0 writes.

    # CPU, gloo
    python scripts/run_multiprocess_torch.py --nprocs 2 --device cpu -- \\
        --mpibayes bayesMPI --bfile demo --pheno demo.phen ...
    # one rank a GPU, NCCL
    python scripts/run_multiprocess_torch.py --nprocs 4 -- ...
    # two ranks sharing one GPU (NCCL refuses that): gloo on CUDA tensors
    python scripts/run_multiprocess_torch.py --nprocs 2 --backend gloo \\
        --same-device -- ...

``python -m torch.distributed.run --standalone --nproc-per-node D -m
hydra_tpu_torch.cli ...`` starts the same ranks. ``launch`` / ``wait_all``
/ ``free_port`` are the JAX launcher's helpers, for the tests.
"""

from __future__ import annotations

import argparse
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(nprocs: int, cli_args, *, device: str = "cpu", backend: str = "",
           same_device: bool = False, port: int = None, stdout_dir: str = None,
           command=None, env=None):
    """Start the ``nprocs`` ranks; returns the Popen list. ``backend``
    defaults to nccl for cuda and gloo for cpu; ``same_device`` puts every
    rank on cuda:0 (needs gloo). ``command`` replaces ``python -m
    hydra_tpu_torch.cli --device <device>`` (the arguments follow it);
    ``env`` adds variables to every rank's environment."""
    backend = backend or ("gloo" if device == "cpu" else "nccl")
    if same_device and backend == "nccl":
        raise ValueError("NCCL refuses two ranks on one device; use gloo")
    port = port or free_port()
    base = list(command) if command else [
        sys.executable, "-m", "hydra_tpu_torch.cli", "--device", device]
    procs = []
    for r in range(nprocs):
        e = dict(os.environ,
                 PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH",
                                                               ""),
                 RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(nprocs),
                 MASTER_ADDR="localhost", MASTER_PORT=str(port),
                 HYDRA_TORCH_BACKEND=backend, **(env or {}))
        for k in ("HYDRA_COORDINATOR", "HYDRA_NUM_PROCS", "HYDRA_PROC_ID"):
            e.pop(k, None)
        if same_device:
            e["HYDRA_TORCH_DEVICE"] = "cuda:0"
        out = (open(os.path.join(stdout_dir, f"rank{r}.log"), "w")
               if stdout_dir else None)
        procs.append(subprocess.Popen(
            base + list(cli_args), env=e, stdout=out,
            stderr=subprocess.STDOUT if out else None))
        if out:
            out.close()
    return procs


def wait_all(procs, timeout: float = 1800, kill_on_failure: bool = True):
    """Wait for every rank. One that dies (crash or kill) leaves the others
    in their next collective, so, as an MPI job, the rest are killed after
    a short grace. Returns the exit codes ("timeout" for a rank killed at
    the deadline)."""
    deadline = time.time() + timeout
    codes = [None] * len(procs)
    while time.time() < deadline and any(c is None for c in codes):
        for i, p in enumerate(procs):
            if codes[i] is None:
                codes[i] = p.poll()
        if kill_on_failure and any(c not in (None, 0) for c in codes):
            time.sleep(2.0)
            for p in procs:
                if p.poll() is None:
                    p.kill()
        time.sleep(0.05)
    for i, p in enumerate(procs):
        if p.poll() is None:
            p.kill()
            p.wait()
            codes[i] = "timeout"
        elif codes[i] is None:
            codes[i] = p.poll()
    return codes


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--nprocs", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default="", choices=("", "nccl", "gloo"),
                    help="default: nccl for cuda, gloo for cpu")
    ap.add_argument("--same-device", action="store_true",
                    help="every rank on cuda:0 (gloo)")
    ap.add_argument("--timeout", type=float, default=1800)
    ap.add_argument("--log-dir", default=None)
    ap.add_argument("cli_args", nargs=argparse.REMAINDER,
                    help="-- then the hydra CLI flags")
    args = ap.parse_args()
    cli = args.cli_args[1:] if args.cli_args[:1] == ["--"] else args.cli_args
    procs = launch(args.nprocs, cli, device=args.device, backend=args.backend,
                   same_device=args.same_device, stdout_dir=args.log_dir)
    codes = wait_all(procs, timeout=args.timeout)
    print(f"exit codes: {codes}")
    return 0 if all(c == 0 for c in codes) else 1


if __name__ == "__main__":
    sys.exit(main())
