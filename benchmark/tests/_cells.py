"""Cells cut to a size the CPU runs in seconds."""

from __future__ import annotations

import dataclasses

from benchmark.config import Cell


def tiny_cell(manifest, name, T, N=20, L=24, **traffic):
    """The cell ``name`` with its configuration's neurons and latent bins
    cut to N and L, and its traffic to T bins (and ``traffic``'s keys)."""
    cell = Cell.load(name, manifest)
    cfg = dataclasses.replace(cell.config, args={
        **cell.config.args, "n_neuron": N, "n_latent_bin": L})
    return dataclasses.replace(cell, config=cfg,
                               traffic={**cell.traffic, "T": T, **traffic})
