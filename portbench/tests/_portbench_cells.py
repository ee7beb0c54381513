"""Cells of BENCHMARK.json cut to a size the CPU runs in seconds."""

import copy


def tiny_cell(name: str, size: int = 16, chs=(8, 16, 16, 16),
              sampler_steps: int = 20):
    """Cell ``name`` of BENCHMARK.json cut to a size the CPU runs in
    seconds: the same kind, traffic and limits; ``size`` voxels a side and
    widths ``chs``. A circular model keeps its padding through a GRF
    data kind (the program pads circular at 256 or on GRF data)."""
    from portbench import run

    cell = run.find_cell(name)
    cell.config = copy.deepcopy(cell.config)
    cfg = cell.config["config"]
    cfg["data"]["cropsize"] = size
    cfg["model"]["chs"] = list(chs)
    if cell.config["padding"] == "circular":
        cfg["data"]["kind"] = "grf"
    if cell.traffic["kind"] == "sample":
        cell.traffic = dict(cell.traffic, sampler_steps=sampler_steps)
    return cell
