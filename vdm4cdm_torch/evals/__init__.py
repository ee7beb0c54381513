"""Evaluation modules: counterpart of ``vdm4cdm_tpu/evals``. Spectra,
log-PDFs and the scattering transform run on the fields' device; ``gpr`` is
host numpy and scipy; ``figures`` imports matplotlib only to render."""

from .figures import draw_figure, draw_figure_sfm, panel_data, render
from .pdfs import log_pdf
from .spectra import get_ccs, pk, pk_conversion, power

__all__ = ["power", "pk", "get_ccs", "pk_conversion", "log_pdf",
           "draw_figure", "draw_figure_sfm", "panel_data", "render"]
