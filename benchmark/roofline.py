"""The work of one call and the least time a card could take for it.

Frozen from the cell's shapes, whatever implements the call: every input
read once and every output the contract returns written once (checkpoints,
re-reads and temporaries do not count), and the operations the
configuration states per column and level.  The peaks are NVIDIA's data
sheet for one H100 SXM at its full 700 W: 3.35 TB/s of HBM3 and 67 TFLOP/s
in float32 (34 in float64) outside the tensor cores.
"""

from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
ITEMSIZE = {"float32": 4, "float64": 8}


def rows(config: dict, traffic: dict):
    """(rows read, rows written) of ``ngptot`` values each: the inputs (pqs
    is one for the unit; the NL sweep computes it), and the 8-stream
    information of the outputs, tangents and adjoints returned."""
    nlev = config["klev"]
    fields_in = 15 if config["unit"] == "nl" else 16
    read = (fields_in - 1) * nlev + nlev + 1  # paph has nlev + 1 rows
    per_output = 8 * nlev
    if config["unit"] == "nl":
        return read, per_output
    written = per_output + read  # the tangents and the 16 adjoints
    if traffic.get("write_primal", True):
        written += per_output
    return read, written


def call_work(config: dict, traffic: dict):
    """(bytes, operations) of one call."""
    read, written = rows(config, traffic)
    row_bytes = config["ngptot"] * ITEMSIZE[config["dtype"]]
    ops = config["ops_per_column_level"] * config["klev"] * config["ngptot"]
    return (read + written) * row_bytes, ops


def least_time_s(config: dict, traffic: dict) -> float:
    nbytes, ops = call_work(config, traffic)
    return max(nbytes / PEAK_BYTES_PER_S, ops / PEAK_FLOPS[config["dtype"]])
