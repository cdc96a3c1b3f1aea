"""The control of the float64 configurations: the plain reference put in
the system's place, one precision below the configuration's float64.

Every input stream is rounded to float32 and the arithmetic is float32
(the whole reference, SATUR's pqs as given).  As in
``adapters/control_bf16.py``, whose entry this is, the reference runs on
the set's stored columns, which the tiled set holds as its first columns,
and its outputs are tiled back to the cell's columns.  The comparison has
to find this not correct.
"""

from __future__ import annotations

from .control_bf16 import entry, outputs, params

__all__ = ["entry", "inputs", "outputs", "params"]


def inputs(tiled: dict, config: dict, traffic: dict):
    nlon = config["stored_columns"]
    return {k: v[:, :nlon].float().T for k, v in tiled.items()}
