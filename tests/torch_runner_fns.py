"""Module-level train functions for the port's process-runner tests.

A spawned runner process unpickles its train function by import path, so
these live in a module that imports neither jax nor the JAX package: a child
that imported the test module would load jax, and the sweep would prove
nothing about the port's own imports."""

import os
import signal


def _claim(flag):
    """True for the one caller that creates ``flag`` (O_EXCL)."""
    try:
        os.close(os.open(flag, os.O_CREAT | os.O_EXCL | os.O_WRONLY))
    except FileExistsError:
        return False
    return True


def train_crash(lr, units, flag, reporter=None):
    """The first trial to claim ``flag`` kills its own runner process: no
    FINAL, no further heartbeats."""
    if _claim(flag):
        os._exit(42)
    return {"metric": 1.0 - (lr - 0.1) ** 2}


def train_wedge(lr, units, flag, reporter=None):
    """The first trial to claim ``flag`` SIGSTOPs its own runner process: it
    stays alive but frozen, heartbeat thread included, like a runner wedged
    in a native call. Only the driver's kill on heartbeat loss reaps it."""
    if _claim(flag):
        os.kill(os.getpid(), signal.SIGSTOP)
        os._exit(43)  # reached only if something resumed the process
    return {"metric": 1.0 - (lr - 0.1) ** 2}


def train_remote(lr, units, reporter=None):
    """A remote agent's trial (``python -m maggy_tpu_torch.runner --train
    torch_runner_fns:train_remote``): the closed form of the JAX package's
    ``tests/remote_train_module.py:train_fn``, with the agent's pid."""
    acc = 1.0 - ((lr - 0.1) ** 2 + ((units - 32) / 64.0) ** 2)
    if reporter is not None:
        reporter.broadcast(acc, step=0)
    return {"metric": acc, "pid": os.getpid()}


def train_remote_gated(lr, units, reporter=None):
    """``train_remote`` that first waits (at most 30 s) until two agent
    processes have each entered a trial, marked under
    MAGGY_TEST_AGENT_DIR: the sweep is then served by both agents, whatever
    their start-up skew."""
    import time

    gate = os.environ["MAGGY_TEST_AGENT_DIR"]
    open(os.path.join(gate, str(os.getpid())), "w").close()
    deadline = time.monotonic() + 30
    while len(os.listdir(gate)) < 2 and time.monotonic() < deadline:
        time.sleep(0.05)
    return train_remote(lr, units, reporter)
