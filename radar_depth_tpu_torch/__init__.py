"""PyTorch / CUDA port of ``radar_depth_tpu`` for NVIDIA Hopper (H100).

A second package beside the JAX one, which stays the reference: the same
serving path (raw schema batch -> radar z-buffer -> two-stage
``resnet18_multistage`` forward), the same train and eval steps
(augmentation -> train-mode forward -> masked multistage loss -> SGD) and
the same training harness (``train/main.py``: Trainer, checkpoints, packed
shards through the native loader, the JAX package's CLI), in PyTorch, with
every Pallas kernel on those paths replaced by a hand-written CUDA C++
kernel for ``sm_90a`` (``csrc/*.cu``, built with ``nvcc`` at first use,
bound with ``ctypes``).

The package imports ``torch`` and numpy, never ``jax`` and nothing of
``radar_depth_tpu``. Entry points (``inference.Predictor``,
``ops.preprocess.prepare_eval_batch`` / ``prepare_train_batch``,
``models.create_model``) run on the card by default; the CPU runs only when
the caller passes ``device="cpu"``; the train and eval steps run where the
model lives.

    from radar_depth_tpu_torch.inference import Predictor
    p = Predictor(cfg, state_dict)          # device="cuda"
    depth = p.predict(batch)                # (B, H, W) meters

    from radar_depth_tpu_torch.train.step import make_train_step
    step = make_train_step(model, spec, train_cfg)
    sums = step(state, batch, generator=torch.Generator("cuda"))

    # python -m radar_depth_tpu_torch.train.main --dataset packed
    #     --data-root DIR --output-dir RUN [--platform cpu]

This module imports nothing heavy.
"""

__version__ = "0.1.0"
