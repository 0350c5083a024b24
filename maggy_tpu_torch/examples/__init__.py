"""The JAX package's eight examples (``examples/*.py``) as the port's own
entry points, each run as ``python -m maggy_tpu_torch.examples.<name>``:

- ``mnist_hpo``: MNIST CNN random search (``--trials 8 --workers 4``).
- ``bert_glue_hpo``: BERT GLUE-style fine-tune, TPE with median stopping
  (``--trials 8``).
- ``llama_lora_sweep``: Llama LoRA sweep under ASHA, only the adapters
  trained, the vocab-chunked loss (``--trials 9 --resource-max 9``).
- ``resnet_cifar_asha``: ResNet/CIFAR ASHA sweep (``--trials 9 --workers 3
  --resource-max 9 --depth 18|50``).
- ``vit_cifar_hpo``: ViT/CIFAR TPE sweep with a swept patch (``--trials 8``).
- ``pbt_sweep``: Population Based Training on the MNIST CNN
  (``--population 6 --generations 4 --workers 3``).
- ``titanic_ablation``: a LOCO ablation study over a TFRecord dataset in the
  dataset registry.
- ``distributed_training``: data-parallel ResNet-18 through
  ``DistributedConfig``.

Each keeps its JAX example's CLI, defaults, search space, configuration,
seeded data and printed lines; ``main(argv=None)`` also takes its
arguments as a list. Trials train on ``fleet.agent.trial_device()``: the
card unless ``MAGGY_TPU_TORCH_DEVICE=cpu`` asks for the CPU (without a card
"cuda" raises; nothing falls back). The model configuration, the batch
shape and the loss's vocab chunk are module-level settings holding the JAX
example's values, which a caller may set before ``main`` (as
``resnet_cifar_asha`` sets ``DEPTH`` from ``--depth``).
"""
