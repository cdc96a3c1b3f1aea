"""The on-card evidence battery: every measurement of the port, each in a
process of its own, checkpointed after every step.

Port of ``tools/onchip_evidence.py``::

    python -m cloudsc2jax_torch.onchip_evidence            # preflight, run all
    python -m cloudsc2jax_torch.onchip_evidence --steps bench_nl,probe_stream
    python -m cloudsc2jax_torch.onchip_evidence --resume   # steps not yet ok
    python -m cloudsc2jax_torch.onchip_evidence --list

It keeps the JAX harness's machinery:

1. a preflight in a subprocess (``torch.cuda.is_available()``); a missing
   card is an error (exit code 2, nothing run, nothing written), never a
   CPU record;
2. each step a subprocess with its own time limit and ``--retries`` more
   attempts (one by default); every attempt is recorded;
3. the record (``--out``, default ``build/onchip_evidence.json`` under the
   checkout) written atomically after every step, so a run that is cut
   keeps what it had, and ``--resume`` runs only the steps not yet ok.

A ``json`` step is ok when it exits 0 and prints a JSON line whose
``platform`` (where it has one) is ``gpu``; a ``text`` step when it exits
0.  The exit code is non-zero when any step's last attempt failed.

The battery: the bench's variants (``nl``; ``tlad`` with and without the
primal streams; ``chunked_tlad``), ``kernel_ab``'s configurations, the
window probe's plain stream and the mixes of ``chip_smoke.py`` phase 16
(plain and compute-weighted), the CUDA-gated tests
(``tests/test_torch_cuda.py`` with ``--noconftest``: the card's machine has
no JAX), and the CLI's ``nl --kernels`` and ``tlad --kernels``.  The JAX
package's ``tools/roofline_capture.sh``, probe ceilings matched to kernel
times, is this battery's probe steps with
:mod:`cloudsc2jax_torch.roofline` (and ``chip_smoke.py`` phases 16-17).
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys
import time

from .bw_probe import KERNEL_MIXES

ROOT = pathlib.Path(__file__).resolve().parents[1]
PY = sys.executable
DEFAULT_OUT = ROOT / "build" / "onchip_evidence.json"

# the window probe at 327,680 columns: 40 blocks of 64 sublanes x 128
PROBE_NB = "40"
AB_CONFIGS = ["two", "noprim", "fused", "enc", "encnp", "two"]


def preflight(timeout_s: int = 120) -> str:
    """``"ok"``, ``"no-cuda"``, ``"timeout"`` or ``"crash"``: whether a
    fresh process sees a card."""
    try:
        r = subprocess.run(
            [PY, "-c", "import torch; raise SystemExit(0 if "
                       "torch.cuda.is_available() else 3)"],
            timeout=timeout_s, capture_output=True, cwd=ROOT)
    except subprocess.TimeoutExpired:
        return "timeout"
    except OSError:
        return "crash"
    if r.returncode == 0:
        return "ok"
    return "no-cuda" if r.returncode == 3 else "crash"


def steps() -> dict:
    """name -> (argv, environment overrides, time limit in s, kind); kind is
    ``json`` (the last JSON line of standard output is the record) or
    ``text`` (the exit code and the output's tails)."""
    bench = [PY, "-m", "cloudsc2jax_torch.bench"]
    probe = [PY, "-m", "cloudsc2jax_torch.bw_probe"]
    cli = [PY, "-m", "cloudsc2jax_torch"]
    battery = {
        "bench_nl": (bench, {"CLOUDSC2_BENCH_VARIANT": "nl"}, 600, "json"),
        # the primal streams pinned both ways: the card's default is noprim
        "bench_tlad": (bench, {"CLOUDSC2_BENCH_VARIANT": "tlad",
                               "CLOUDSC2_BENCH_WRITE_PRIMAL": "1"}, 900, "json"),
        "bench_tlad_noprim": (bench, {"CLOUDSC2_BENCH_VARIANT": "tlad",
                                      "CLOUDSC2_BENCH_WRITE_PRIMAL": "0",
                                      "CLOUDSC2_BENCH_F32_CHECKS": "0"}, 900, "json"),
        "bench_chunked_tlad": (bench, {"CLOUDSC2_BENCH_VARIANT": "chunked_tlad"},
                               1200, "json"),
        "kernel_ab": ([PY, "-m", "cloudsc2jax_torch.kernel_ab", *AB_CONFIGS],
                      {"CLOUDSC2_AB_NGPTOT": "327680"}, 1200, "json"),
        "probe_stream": (probe, {"CLOUDSC2_BW_PROBE_MB": "256"}, 300, "json"),
    }
    for label, reads, writes, rev, weighted in KERNEL_MIXES:
        env = {"CLOUDSC2_BW_PROBE_WINDOWS": f"{reads}x{writes}",
               "CLOUDSC2_BW_PROBE_NB": PROBE_NB,
               "CLOUDSC2_BW_PROBE_REV": "1" if rev else "0"}
        battery[f"probe_{label}"] = (probe, env, 300, "json")
        if weighted is not None:
            battery[f"probe_{label}_compute"] = (probe, {
                **env, "CLOUDSC2_BW_PROBE_COMPUTE": "%d,%d" % weighted}, 300, "json")
    battery.update({
        "cuda_tests": ([PY, "-m", "pytest", "tests/test_torch_cuda.py", "-q",
                        "-p", "no:cacheprovider", "--noconftest"], {}, 2400, "text"),
        # f32 validates at 1e4 working-precision epsilons
        "cli_nl": (cli + ["nl", "1", "163840", "128", "--dtype", "f32",
                          "--threshold", "10000", "--kernels"], {}, 600, "text"),
        "cli_tlad": (cli + ["tlad", "1", "163840", "128", "--dtype", "f32",
                            "--kernels"], {}, 600, "text"),
    })
    return battery


def _json_lines(text: str) -> list:
    out = []
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("{") and line.endswith("}"):
            try:
                out.append(json.loads(line))
            except ValueError:
                pass
    return out


def run_step(name: str, argv, env_over: dict, timeout_s: int, kind: str,
             retries: int = 1) -> dict:
    """Run one step, up to ``1 + retries`` attempts; the record of its last
    attempt, with every attempt's exit code and seconds in ``history``."""
    env = {**os.environ, **env_over}
    rec = {"name": name, "argv": list(argv[1:]), "env": env_over, "attempts": 0,
           "history": [], "ok": False}
    for attempt in range(retries + 1):
        rec["attempts"] = attempt + 1
        t0 = time.time()
        try:
            r = subprocess.run(argv, env=env, cwd=ROOT, timeout=timeout_s,
                               capture_output=True, text=True)
            rc, out, err = r.returncode, r.stdout, r.stderr
        except subprocess.TimeoutExpired as e:
            out = e.stdout.decode() if isinstance(e.stdout, bytes) else (e.stdout or "")
            rc, err = -1, f"TIMEOUT after {timeout_s} s"
        except OSError as e:
            rc, out, err = -2, "", f"could not start: {e!r}"
        rec.update(seconds=round(time.time() - t0, 1), rc=rc,
                   stdout_tail=out[-4000:], stderr_tail=err[-4000:],
                   timestamp=time.strftime("%Y-%m-%dT%H:%M:%S"))
        rec.pop("record", None)
        rec.pop("not_ok_reason", None)
        records = _json_lines(out) if kind == "json" else []
        if records:
            rec["record"] = records[-1]
        on_card = all(r.get("platform", "gpu") == "gpu" for r in records)
        rec["ok"] = rc == 0 and (kind == "text" or bool(records)) and on_card
        if rc == 0 and records and not on_card:
            rec["not_ok_reason"] = "the record reports another platform than gpu"
        rec["history"].append({"rc": rc, "seconds": rec["seconds"]})
        if rec["ok"]:
            break
        print(f"  [{name}] attempt {attempt + 1} failed (rc={rc}); "
              f"{'retrying' if attempt < retries else 'giving up'}", file=sys.stderr)
    return rec


def derive(results: dict) -> dict:
    """Verdicts across steps, from the records captured so far."""
    d = {}
    nl = results.get("bench_nl", {}).get("record")
    if nl:
        d["nl_columns_per_second"] = nl.get("value")
    tlad = results.get("bench_tlad", {}).get("record", {})
    if "f32_verdicts" in tlad:
        d["f32_verdicts"] = tlad["f32_verdicts"]
    noprim = results.get("bench_tlad_noprim", {}).get("record", {})
    if tlad.get("value") and noprim.get("value"):
        d["noprim_speedup_vs_tlad"] = noprim["value"] / tlad["value"]
    for name, rec in results.items():
        if name.startswith("probe_") and rec.get("record"):
            d[f"{name}_attained_gbps"] = rec["record"].get("attained_gbps")
    ab = results.get("kernel_ab", {}).get("record", {}).get("configs", {})
    if ab:
        d["kernel_ab_ms"] = {k: v["ms"] for k, v in ab.items()}
    return d


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cloudsc2jax_torch.onchip_evidence",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--steps", default=None, help="comma-separated subset")
    ap.add_argument("--list", action="store_true", help="print the battery")
    ap.add_argument("--resume", action="store_true",
                    help="skip the steps already ok in the existing record")
    ap.add_argument("--no-preflight", action="store_true")
    ap.add_argument("--retries", type=int, default=1)
    ap.add_argument("--out", default=str(DEFAULT_OUT))
    args = ap.parse_args(argv)

    battery = steps()
    if args.list:
        for name, (cmd, env, t, kind) in battery.items():
            print(f"{name:22s} {kind:4s} timeout={t:5d}s  {' '.join(cmd[1:])}  {env}")
        return 0
    selected = args.steps.split(",") if args.steps else list(battery)
    unknown = [s for s in selected if s not in battery]
    if unknown:
        ap.error(f"unknown steps {unknown}; see --list")
    if not args.no_preflight:
        outcome = preflight()
        if outcome != "ok":
            print(f"onchip_evidence: preflight {outcome}: no card answers; "
                  f"nothing run", file=sys.stderr)
            return 2

    out = pathlib.Path(args.out)
    doc = {"started": time.strftime("%Y-%m-%dT%H:%M:%S"), "results": {}}
    if out.exists():
        try:
            prev = json.loads(out.read_text())
            doc.update(started=prev.get("started", doc["started"]),
                       results=prev.get("results", {}))
        except ValueError:
            pass

    def save():
        doc["derived"] = derive(doc["results"])
        doc["updated"] = time.strftime("%Y-%m-%dT%H:%M:%S")
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(out.name + ".tmp")
        tmp.write_text(json.dumps(doc, indent=1))
        os.replace(tmp, out)

    n_ok = 0
    for name in selected:
        if args.resume and doc["results"].get(name, {}).get("ok"):
            print(f"[{name}] already ok, skipped (--resume)", file=sys.stderr)
            n_ok += 1
            continue
        cmd, env_over, timeout_s, kind = battery[name]
        print(f"[{name}] running {' '.join(cmd[1:])} {env_over}", file=sys.stderr)
        rec = run_step(name, cmd, env_over, timeout_s, kind, retries=args.retries)
        doc["results"][name] = rec
        n_ok += rec["ok"]
        save()
        print(f"[{name}] {'ok' if rec['ok'] else 'FAILED'} in {rec['seconds']} s",
              file=sys.stderr)
    save()
    print(json.dumps({"onchip_evidence": str(out), "steps_ok": n_ok,
                      "steps_run": len(selected), "derived": doc["derived"]}))
    return 0 if n_ok == len(selected) else 1


if __name__ == "__main__":
    raise SystemExit(main())
