from .schedule import NoiseSchedule, alpha_sigma, make_schedule
from .vdm import VDM

__all__ = ["NoiseSchedule", "VDM", "alpha_sigma", "make_schedule"]
