"""Where a fresh process's first trial set-up spends its time on the card.

    python3 -m maggy_tpu_torch.train.init_probe [--cache-dir DIR]

Each probe runs in a new process (started from here in turn) and times, in
order: ``import torch``, the CUDA context, ``import maggy_tpu_torch.train``,
the first ``Trainer.init`` (under cProfile) of a model built on the meta
device, its first three steps and a second ``Trainer.init``. The models are
``chip_smoke.py``'s: the MNIST CNN (16 x 16 images, batch 128, ``adam``)
and BERT-base without dropout (32 x 128 tokens, key padding, ``adamw``),
both through ``swept_transform``, on seeded data. The flash kernels are
built first, so no first step waits on nvcc. Both probes run three times:
in the environment as given, then with one bytecode cache in ``DIR``
(``PYTHONPYCACHEPREFIX``, with ``PYTHONDONTWRITEBYTECODE`` unset; default
``build/init_probe_pycache``) while it is cold and once it is warm. Prints
one JSON line a probe: the times in seconds, which of ``HEAVY`` are loaded
after the first init and after its steps, and the cProfile's top entries
by cumulative time. Needs a CUDA card (exits 1 without one); imports
nothing of JAX.
"""

import json
import os
import shutil
import subprocess
import sys

#: The directory that holds the package, put first on a probe's path.
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
#: Modules whose first import is the bulk of a lazy first use.
HEAVY = ("sympy", "torch._refs", "torch.fx.experimental.symbolic_shapes", "torch._dynamo")


def probe(model):
    import cProfile
    import io
    import pstats
    import time

    times = {}
    t = time.perf_counter()
    import numpy as np
    import torch
    times["import_torch"] = time.perf_counter() - t
    if not torch.cuda.is_available():
        raise SystemExit("init_probe: no CUDA device")
    t = time.perf_counter()
    torch.cuda.init()
    torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    times["cuda_context"] = time.perf_counter() - t
    t = time.perf_counter()
    from maggy_tpu_torch.train import Trainer, adam, adamw, cross_entropy_loss, swept_transform
    times["import_package"] = time.perf_counter() - t
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.default_rng(0)

    def loss(logits, b):
        return cross_entropy_loss(logits, b["labels"])

    if model == "mnist":
        from maggy_tpu_torch.models import MnistCNN

        x = rng.normal(size=(128, 16, 16, 1)).astype(np.float32)
        y = (x.mean(axis=(1, 2, 3)) > 0).astype(np.int64)
        batch = {"inputs": (torch.as_tensor(x, device="cuda"),),
                 "labels": torch.as_tensor(y, device="cuda")}

        def make():
            return Trainer(MnistCNN(kernel_size=3, pool_size=2, features=16, num_classes=2,
                                    image_size=16, device="meta"),
                           swept_transform(adam, learning_rate=1e-3), loss, device="cuda")
    else:
        import dataclasses

        from maggy_tpu_torch.models import BertConfig, BertEncoder

        cfg = dataclasses.replace(BertConfig.base(), dropout=0.0)
        tokens = rng.integers(2, cfg.vocab_size, size=(32, 128))
        lens = rng.integers(16, 129, size=32)
        mask = np.arange(128)[None, :] < lens[:, None]
        labels = (((tokens > cfg.vocab_size // 2) & mask).sum(1) * 2 > lens).astype(np.int64)
        batch = {"inputs": (torch.as_tensor(tokens, device="cuda"),
                            torch.as_tensor(mask, device="cuda")),
                 "labels": torch.as_tensor(labels, device="cuda")}

        def make():
            return Trainer(BertEncoder(cfg, device="meta"),
                           swept_transform(adamw, learning_rate=3e-5), loss, device="cuda")
    prof = cProfile.Profile()
    t = time.perf_counter()
    prof.enable()
    trainer = make().init(seed=0)
    torch.cuda.synchronize()
    prof.disable()
    times["first_init"] = time.perf_counter() - t
    loaded = {"after_init": sorted(m for m in HEAVY if m in sys.modules)}
    for i in range(3):
        t = time.perf_counter()
        float(trainer.step(batch))
        times["first_steps_{}".format(i)] = time.perf_counter() - t
    loaded["after_steps"] = sorted(m for m in HEAVY if m in sys.modules)
    del trainer
    t = time.perf_counter()
    make().init(seed=1)
    torch.cuda.synchronize()
    times["second_init"] = time.perf_counter() - t
    out = io.StringIO()
    pstats.Stats(prof, stream=out).sort_stats("cumulative").print_stats(25)
    top = [line for line in out.getvalue().splitlines() if line.strip()][-30:]
    print(json.dumps({"model": model, "times_s": times, "loaded": loaded,
                      "first_init_profile": top}), flush=True)


def run(argv):
    cache = os.path.abspath(argv[argv.index("--cache-dir") + 1] if "--cache-dir" in argv
                            else os.path.join("build", "init_probe_pycache"))
    here = os.path.abspath(__file__)
    rc = subprocess.call([sys.executable, "-c", "import sys, torch; "
                          "sys.exit(0 if torch.cuda.is_available() else 1)"])
    if rc:
        print("init_probe: no CUDA device", file=sys.stderr)
        return 1
    rc = subprocess.call([sys.executable, "-c", "from maggy_tpu_torch.ops.build import "
                          "compile_all; compile_all()"], cwd=ROOT)
    shutil.rmtree(cache, ignore_errors=True)
    cached = {k: v for k, v in os.environ.items() if k != "PYTHONDONTWRITEBYTECODE"}
    cached["PYTHONPYCACHEPREFIX"] = cache
    for label, env in (("as_given", dict(os.environ)), ("bytecode_cache_cold", cached),
                       ("bytecode_cache_warm", cached)):
        for model in ("mnist", "bert_base"):
            print(json.dumps({"run": label, "model": model,
                              "PYTHONDONTWRITEBYTECODE": env.get("PYTHONDONTWRITEBYTECODE")}),
                  flush=True)
            rc |= subprocess.call([sys.executable, here, "--probe", model], env=env)
    return rc


if __name__ == "__main__":
    if sys.argv[1:2] == ["--probe"]:
        # Run as a script: the package, not this file's directory, comes
        # first on the path.
        sys.path[0] = ROOT
        probe(sys.argv[2])
    else:
        sys.exit(run(sys.argv[1:]))
