"""Scene registry."""

from hot_tpu_torch.scenes.registry import SCENES, build_scene  # noqa: F401
