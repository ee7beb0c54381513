from .ddnm import ddnm_sample
from .schedule import NoiseSchedule, alpha_sigma, make_schedule
from .vdm import VDM, VDMLosses

__all__ = ["NoiseSchedule", "VDM", "VDMLosses", "alpha_sigma",
           "ddnm_sample", "make_schedule"]
