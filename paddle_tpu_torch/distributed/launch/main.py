"""The collective launcher (``launch/main.py`` +
``controllers/collective.py`` of the reference)."""

from __future__ import annotations

import argparse
import os
import signal
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

from ..env import free_port


def build_env(rank: int, nprocs: int, master: str, base: Dict[str, str],
              device: Optional[str] = None,
              backend: Optional[str] = None) -> Dict[str, str]:
    """Rank ``rank``'s environment: ``base`` plus the launcher's
    variables; ``device`` is the card it takes (``FLAGS_selected_gpus``)."""
    env = dict(base)
    host, port = master.rsplit(":", 1)
    env.update({
        "PADDLE_TRAINER_ID": str(rank),
        "PADDLE_TRAINERS_NUM": str(nprocs),
        "PADDLE_MASTER": master,
        "MASTER_ADDR": host,
        "MASTER_PORT": port,
        "PADDLE_RANK_IN_NODE": str(rank),
        "PADDLE_LOCAL_SIZE": str(nprocs),
    })
    if device is not None:
        env["FLAGS_selected_gpus"] = str(device)
    if backend:
        env["PADDLE_DISTRI_BACKEND"] = backend
    return env


class Pod:
    """The local rank processes (``launch/job/pod.py``)."""

    def __init__(self):
        self.procs: List[subprocess.Popen] = []
        self.logs: list = []

    def spawn(self, cmd: List[str], envs: List[Dict[str, str]],
              log_dir: Optional[str]):
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
        for rank, env in enumerate(envs):
            out = (open(os.path.join(log_dir, f"workerlog.{rank}"), "w")
                   if log_dir else None)
            self.logs.append(out)
            self.procs.append(subprocess.Popen(cmd, env=env, stdout=out,
                                               stderr=out))

    def poll(self) -> Optional[int]:
        """None while ranks run; 0 when all exited 0; else the first
        failing rank's code (the others stopped)."""
        codes = [p.poll() for p in self.procs]
        if all(c == 0 for c in codes):
            return 0
        bad = [c for c in codes if c not in (None, 0)]
        if bad:
            self.terminate()
            return bad[0]
        return None

    def watch(self) -> int:
        try:
            while True:
                code = self.poll()
                if code is not None:
                    return code
                time.sleep(0.1)
        finally:
            self.terminate()
            for f in self.logs:
                if f:
                    f.close()
            self.logs = []

    def terminate(self):
        for p in self.procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        deadline = time.time() + 5
        for p in self.procs:
            try:
                p.wait(max(0.1, deadline - time.time()))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def launch(script: str, script_args: Sequence[str] = (),
           nproc_per_node: Optional[int] = None,
           master: Optional[str] = None, log_dir: Optional[str] = None,
           devices: Optional[Sequence] = None,
           backend: Optional[str] = None) -> int:
    """Run ``script`` in ``nproc_per_node`` rank processes (one a card of
    ``devices`` when given) and return the exit code: 0, or the first
    failing rank's."""
    if devices is not None:
        devices = [str(d) for d in devices]
        if nproc_per_node is not None and nproc_per_node != len(devices):
            raise ValueError(f"--nproc_per_node {nproc_per_node} and "
                             f"--devices {','.join(devices)} disagree")
        nproc_per_node = len(devices)
    nproc_per_node = nproc_per_node or 1
    master = master or f"127.0.0.1:{free_port()}"
    cmd = [sys.executable, "-u", script, *script_args]
    envs = [build_env(r, nproc_per_node, master, dict(os.environ),
                      devices[r] if devices else None, backend)
            for r in range(nproc_per_node)]
    pod = Pod()
    pod.spawn(cmd, envs, log_dir)
    return pod.watch()


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="paddle_tpu_torch.distributed.launch",
        description="Launch collective training: one process a rank")
    p.add_argument("--nproc_per_node", type=int, default=None,
                   help="rank processes on this host")
    p.add_argument("--devices", "--gpus", default=None,
                   help="the cards to use, comma-separated: one rank each")
    p.add_argument("--master", default=None, help="rendezvous host:port")
    p.add_argument("--log_dir", default=None,
                   help="write rank i's output to LOG_DIR/workerlog.i")
    p.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                   help="the ranks' backend (default: NCCL on cards, gloo "
                        "on the CPU)")
    p.add_argument("script")
    p.add_argument("script_args", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    devices = args.devices.split(",") if args.devices else None
    return launch(args.script, args.script_args,
                  nproc_per_node=args.nproc_per_node, master=args.master,
                  log_dir=args.log_dir, devices=devices,
                  backend=args.backend)


if __name__ == "__main__":
    sys.exit(main())
