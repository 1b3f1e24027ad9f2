"""PyTorch / CUDA port of ``radar_depth_tpu`` for NVIDIA Hopper (H100).

A second package beside the JAX one, which stays the reference: the same
serving path (raw schema batch -> radar z-buffer -> two-stage
``resnet18_multistage`` forward), in PyTorch, with every Pallas kernel on that
path replaced by a hand-written CUDA C++ kernel for ``sm_90a``
(``csrc/*.cu``, built with ``nvcc`` at first use, bound with ``ctypes``).

The package imports ``torch`` and numpy, never ``jax`` and nothing of
``radar_depth_tpu``. Entry points (``inference.Predictor``,
``ops.preprocess.prepare_eval_batch``, ``models.create_model``) run on the
card by default; the CPU runs only when the caller passes ``device="cpu"``.

    from radar_depth_tpu_torch.inference import Predictor
    p = Predictor(cfg, state_dict)          # device="cuda"
    depth = p.predict(batch)                # (B, H, W) meters

This module imports nothing heavy.
"""

__version__ = "0.1.0"
