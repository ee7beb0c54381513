from .sfm import SFM, SFMLosses

__all__ = ["SFM", "SFMLosses"]
