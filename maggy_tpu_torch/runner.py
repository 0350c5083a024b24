"""Remote trial-runner agent: ``python -m maggy_tpu_torch.runner``.

The port's copy of ``maggy_tpu/runner.py:42-221``. A driver with
``pool="remote"`` writes a join ticket (address and secret) to
``<exp_dir>/runner_ticket.json``; an agent process reads it, JOINs to
receive its partition id and executor config, and runs the trial-executor
loop (register -> heartbeat -> get_suggestion -> train -> FINAL) until
GSTOP. Each agent is its own process with its own CUDA context. The port's
driver binds loopback, so its agents run on the driver's host; the JAX
package's ``OptimizationConfig.bind_host`` (0.0.0.0 for remote pools, the
ticket advertising the host's address) waits for the multi-host work of
ROADMAP queue 1 item 8. Agents on other hosts join a fleet instead:
``Fleet(bind_host=...)`` and ``python -m maggy_tpu_torch.fleet agent``.

The train function is named by a dotted path (``pkg.module:fn``) and
imported on the agent; only declarative data crosses the network. Importing
its module must start nothing.

Usage:

    python -m maggy_tpu_torch.runner --ticket /shared/exp_dir/runner_ticket.json \\
        --train my_project.train:train_fn

or, without a shared filesystem:

    python -m maggy_tpu_torch.runner --driver 127.0.0.1:41234 --secret-file s.txt \\
        --train my_project.train:train_fn

Cut (ROADMAP queue 1 item 8): the distributed-training branch of
``run_agent`` (a JOIN reply whose ``trial_type`` is "distributed"), its
``--config`` factory, and ``--chips-per-agent`` / ``--agent-index``
device pinning for gang sub-slices. ``--profile`` traces every trial the
agent runs (``profiling.trial_profile``).
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import socket
import sys
import time
from typing import Callable, Optional, Tuple

from maggy_tpu_torch import constants
from maggy_tpu_torch.core.executors.trial_executor import TrialExecutor
from maggy_tpu_torch.core.rpc import MessageSocket


def load_train_fn(spec: str) -> Callable:
    """Resolve ``pkg.module:fn`` to the callable it names."""
    mod_name, sep, fn_name = spec.partition(":")
    if not sep or not mod_name or not fn_name:
        raise ValueError("--train must be 'package.module:function', got {!r}".format(spec))
    module = importlib.import_module(mod_name)
    fn = module
    for part in fn_name.split("."):
        fn = getattr(fn, part)
    if not callable(fn):
        raise TypeError("{!r} resolved to non-callable {!r}".format(spec, fn))
    return fn


def join_experiment(addr: Tuple[str, int], secret: str, partition_id: Optional[int] = None,
                    timeout: float = 30.0) -> dict:
    """One JOIN: the driver's partition id and executor config for this
    agent."""
    key = secret.encode() if isinstance(secret, str) else secret
    sock = socket.create_connection(addr, timeout=timeout)
    try:
        MessageSocket.send_msg(sock, {"type": "JOIN", "partition_id":
                                      -1 if partition_id is None else partition_id}, key)
        resp = MessageSocket.recv_msg(sock, key)
    finally:
        sock.close()
    if resp.get("type") != "JOIN":
        raise RuntimeError("JOIN rejected: {}".format(resp.get("error", resp)))
    return resp


def read_ticket(path: str, wait_s: float = 0.0) -> dict:
    """The driver's join ticket, waiting up to ``wait_s`` for it to appear
    (the driver writes it when the experiment starts). A partial read (a
    writer that is not atomic on a shared filesystem) retries."""
    deadline = time.monotonic() + wait_s
    while True:
        if os.path.exists(path):
            try:
                with open(path) as f:
                    ticket = json.load(f)
                ticket["host"], ticket["port"], ticket["secret"]
                return ticket
            except (json.JSONDecodeError, KeyError, OSError):
                pass
        if time.monotonic() >= deadline:
            raise FileNotFoundError("No join ticket at {}".format(path))
        time.sleep(0.5)


def run_agent(driver_addr: Tuple[str, int], secret: str, train_fn: Callable,
              partition_id: Optional[int] = None, profile: bool = False) -> int:
    """Join the experiment and run the trial loop to its GSTOP; returns the
    partition id served."""
    info = join_experiment(driver_addr, secret, partition_id)
    if info.get("trial_type") == "distributed":
        raise NotImplementedError(
            "distributed-training agents are not ported yet (ROADMAP queue 1 item 8)")
    executor = TrialExecutor(
        server_addr=driver_addr, secret=secret, hb_interval=info["hb_interval"],
        exp_dir=info["exp_dir"], optimization_key=info["optimization_key"],
        train_fn=train_fn, warm_start=info.get("warm_start", True),
        trial_type=info.get("trial_type", "optimization"), profile=profile)
    executor(info["partition_id"])
    return info["partition_id"]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="maggy_tpu_torch.runner",
                                description="Remote trial-runner agent.")
    p.add_argument("--ticket", help="path to the driver's runner_ticket.json")
    p.add_argument("--wait-ticket", type=float, default=float(
        os.environ.get("MAGGY_TPU_TICKET_WAIT_S", constants.REGISTRATION_TIMEOUT_S)),
        help="seconds to wait for the ticket file to appear")
    p.add_argument("--driver", help="driver control-plane address HOST:PORT")
    p.add_argument("--secret", help="shared experiment secret (hex)")
    p.add_argument("--secret-file", help="file containing the shared secret")
    p.add_argument("--train", required=True,
                   help="train function as 'package.module:function'")
    p.add_argument("--partition-id", type=int, default=None,
                   help="reclaim a specific runner slot (restart recovery)")
    p.add_argument("--profile", action="store_true",
                   help="capture a torch.profiler trace per trial")
    args = p.parse_args(argv)

    if args.ticket:
        ticket = read_ticket(args.ticket, wait_s=args.wait_ticket)
        addr = (ticket["host"], int(ticket["port"]))
        secret = ticket["secret"]
    elif args.driver:
        host, _, port = args.driver.rpartition(":")
        addr = (host, int(port))
        if args.secret_file:
            with open(args.secret_file) as f:
                secret = f.read().strip()
        elif args.secret:
            secret = args.secret
        else:
            p.error("--driver requires --secret or --secret-file")
    else:
        p.error("one of --ticket or --driver is required")

    train_fn = load_train_fn(args.train)
    pid = run_agent(addr, secret, train_fn, partition_id=args.partition_id,
                    profile=args.profile)
    print("runner {} done".format(pid))
    return 0


if __name__ == "__main__":
    sys.exit(main())
