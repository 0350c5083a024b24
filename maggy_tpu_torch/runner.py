"""Remote trial-runner agent: ``python -m maggy_tpu_torch.runner``.

The port's copy of ``maggy_tpu/runner.py:42-221``. A driver with
``pool="remote"`` writes a join ticket (address and secret) to
``<exp_dir>/runner_ticket.json``; an agent process reads it, JOINs to
receive its partition id and executor config, and runs the trial-executor
loop (register -> heartbeat -> get_suggestion -> train -> FINAL) until
GSTOP, or, for a ``DistributedConfig(backend="remote")`` experiment (the
JOIN reply's ``trial_type`` is "distributed"), one rank of the training
world: a ``DistExecutor`` built from the reply's world size, mesh, strategy
and device, or from ``--config``'s factory (the JAX package's
``maggy_tpu/runner.py:112-126``). Each agent is its own process with its
own CUDA context. A distributed experiment's driver binds ``bind_host``
(0.0.0.0 by default) and advertises a reachable address; an optimization
experiment's driver binds loopback, so its agents run on the driver's
host, and agents on other hosts join a fleet instead
(``Fleet(bind_host=...)`` and ``python -m maggy_tpu_torch.fleet agent``).

The train function is named by a dotted path (``pkg.module:fn``) and
imported on the agent; only declarative data crosses the network. Importing
its module must start nothing.

Usage:

    python -m maggy_tpu_torch.runner --ticket /shared/exp_dir/runner_ticket.json \\
        --train my_project.train:train_fn

or, without a shared filesystem:

    python -m maggy_tpu_torch.runner --driver 127.0.0.1:41234 --secret-file s.txt \\
        --train my_project.train:train_fn

``--chips-per-agent K --agent-index i`` pins the agent to CUDA devices
[i*K, (i+1)*K) of its host before anything touches the card (one agent a
device subset, ``maggy_tpu/runner.py:170-191``). ``--profile`` traces every
trial the agent runs (``profiling.trial_profile``).
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
              partition_id: Optional[int] = None, profile: bool = False,
              config_factory: Optional[Callable] = None) -> int:
    """Join the experiment and run its executor to the end: the trial loop
    to GSTOP, or one rank of a distributed experiment's world (the JOIN
    reply's ``trial_type`` decides). Returns the partition id served."""
    info = join_experiment(driver_addr, secret, partition_id)
    if info.get("trial_type") == "distributed":
        executor = _dist_executor(driver_addr, secret, train_fn, info, profile, config_factory)
        executor(info["partition_id"])
        return info["partition_id"]
    executor = TrialExecutor(
        server_addr=driver_addr, secret=secret, hb_interval=info["hb_interval"],
        exp_dir=info["exp_dir"], optimization_key=info["optimization_key"],
        train_fn=train_fn, warm_start=info.get("warm_start", True),
        trial_type=info.get("trial_type", "optimization"), profile=profile)
    executor(info["partition_id"])
    return info["partition_id"]


def _dist_executor(driver_addr, secret, train_fn, info, profile, config_factory):
    """A rank's ``DistExecutor``: model and dataset objects cannot travel
    over the wire, so a config factory builds them on the agent; without
    one the world's shape comes from the JOIN reply and the train function
    sees only the sharding env."""
    from maggy_tpu_torch.config import DistributedConfig
    from maggy_tpu_torch.core.executors.dist_executor import DistExecutor
    from maggy_tpu_torch.util import address_toward

    config = config_factory() if config_factory else DistributedConfig(
        num_workers=info["num_workers"], mesh_shape=info.get("mesh_shape") or {},
        strategy=info.get("strategy", "dp"), device=info.get("device", "cuda"),
        hb_interval=info["hb_interval"], hb_loss_timeout=info.get("hb_loss_timeout"),
        profile=profile or bool(info.get("profile")))
    return DistExecutor(
        server_addr=driver_addr, secret=secret, hb_interval=info["hb_interval"],
        exp_dir=info["exp_dir"], train_fn=train_fn, config=config,
        num_workers=info["num_workers"], shared_process=False,
        coord_host=address_toward(driver_addr))


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
    p.add_argument("--config",
                   help="for distributed experiments: a zero-argument factory "
                        "'package.module:function' returning the local DistributedConfig "
                        "(model and datasets built on the agent)")
    p.add_argument("--partition-id", type=int, default=None,
                   help="reclaim a specific runner slot (restart recovery)")
    p.add_argument("--profile", action="store_true",
                   help="capture a torch.profiler trace per trial")
    p.add_argument("--chips-per-agent", type=int, default=None,
                   help="pin this agent to a disjoint CUDA device subset of its host: "
                        "devices [agent-index*K, (agent-index+1)*K)")
    p.add_argument("--agent-index", type=int, default=0,
                   help="this agent's index among the agents on this host; selects its "
                        "device subset")
    args = p.parse_args(argv)

    if args.chips_per_agent is not None:
        # Before the first CUDA call of this process (the executor's first
        # device touch): the same pinning the gpu runner pool applies.
        from maggy_tpu_torch.core.runner_pool import device_env

        if args.chips_per_agent <= 0:
            p.error("--chips-per-agent must be >= 1")
        if args.agent_index < 0:
            p.error("--agent-index must be >= 0")
        os.environ.update(device_env(args.agent_index, args.chips_per_agent))

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
    factory = load_train_fn(args.config) if args.config else None
    pid = run_agent(addr, secret, train_fn, partition_id=args.partition_id,
                    profile=args.profile, config_factory=factory)
    print("runner {} done".format(pid))
    return 0


if __name__ == "__main__":
    sys.exit(main())
