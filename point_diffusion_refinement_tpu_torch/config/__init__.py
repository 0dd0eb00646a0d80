from .loader import DEFAULT_POINTNET_CONFIG, tiny_pointnet_config

__all__ = ["DEFAULT_POINTNET_CONFIG", "tiny_pointnet_config"]
