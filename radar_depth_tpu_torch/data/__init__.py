"""Dataset layer of the port: the sample schema and the synthetic
nuScenes-like generator (numpy only, own copies of the JAX package's), and
in ``data/packed.py`` the packed shards and the native loader."""

from radar_depth_tpu_torch.data.schema import Batch, Sample, SampleSpec
from radar_depth_tpu_torch.data.synthetic import SceneConfig, SyntheticNuScenes

__all__ = ["Sample", "Batch", "SampleSpec", "SyntheticNuScenes", "SceneConfig"]
