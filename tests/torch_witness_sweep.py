"""How far one epoch of the training CLI carries a rounding-level change,
on the CPU alone (no card needed).

One epoch of ``cli/train_rollout.py`` on ``conf/autoreg_physrnn.yaml`` (or
the yaml given) at its default 384 columns with ``device=cpu``: once from
the CLI's initial weights, then from them times 1 + 1e-6 and 1 - 1e-6, the
physics model's discrete choices replayed from the first run
(``chip_smoke.ChoiceReplay``). Then the validation of the first run's
trained weights, and of them times 1 +- 1e-6, on the same choices. Prints
one JSON line: the first run's loss and val_loss, each witness run's
differences from them ("trained"), and each trained-weights witness's
val_loss difference ("forward").

The synthetic data depends on Python's string hash, so run it under
several salts::

    for s in 1 2 3 4 5 6 7 8; do
        PYTHONHASHSEED=$s python tests/torch_witness_sweep.py
    done
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import sys
import tempfile

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from climsim_tpu_torch.cli import train_rollout as cli  # noqa: E402
from climsim_tpu_torch.train.config import load_config  # noqa: E402


def main(yaml: str) -> dict:
    runs = []
    setup = cli.setup

    def keep(cfg):
        runs.append(setup(cfg))
        return runs[-1]
    cli.setup = keep
    scaled = lambda st, f: {k: v * f if v.is_floating_point() else v
                            for k, v in st.items()}
    with tempfile.TemporaryDirectory() as tmp:
        grid = os.path.join(tmp, "grid.nc")
        cs.write_grid_file(grid, cs.LO_NLAT * cs.LO_NLON)
        base = [yaml, f"grid_path={grid}", "epochs=1", "device=cpu"]
        init = keep(load_config(yaml, base[1:])).trainer.model.state_dict()
        paths = {}
        for s in (1, -1):
            paths[s] = os.path.join(tmp, f"witness{s}.pt")
            torch.save(scaled(init, 1 + s * 1e-6), paths[s])

        def epoch(extra, replay):
            out = io.StringIO()
            with replay, contextlib.redirect_stdout(out):
                rc = cli.main(base + extra)
            cs.check(rc == 0, f"exit {rc}")
            return [json.loads(ln) for ln in out.getvalue().splitlines()
                    if ln.startswith('{"epoch"')][0]
        recorder = cs.ChoiceReplay()
        first = epoch([], recorder)
        calls, run = recorder.calls, runs[-1]
        trained = {k: v.clone() for k, v in run.trainer.model.state_dict()
                   .items()}
        res = {"salt": os.environ.get("PYTHONHASHSEED"),
               "loss": first["loss"], "val_loss": first["val_loss"]}
        for s in (1, -1):
            r = epoch([f"init_from={paths[s]}"], cs.ChoiceReplay(calls))
            res[f"trained{s:+d}"] = {k: r[k] - first[k]
                                     for k in ("loss", "val_loss")}
        # validation alone replays the last of the first run's choices
        tr = run.trainer

        def val(state, replay):
            tr.model.load_state_dict(state)
            with replay:
                _, v = tr.run_epoch(None, run.chunks(run.ntr, None, False), 0,
                                    train=False)
            return v["loss"], replay
        _, probe = val(trained, cs.ChoiceReplay())
        vcalls = calls[len(calls) - len(probe.calls):]
        v0, _ = val(trained, cs.ChoiceReplay(vcalls))
        cs.check(v0 == first["val_loss"], f"validation {v0} against the "
                 f"run's {first['val_loss']}")
        for s in (1, -1):
            v, _ = val(scaled(trained, 1 + s * 1e-6), cs.ChoiceReplay(vcalls))
            res[f"forward{s:+d}"] = v - v0
    cli.setup = setup
    return res


if __name__ == "__main__":
    torch.set_num_threads(int(os.environ.get("SWEEP_THREADS", "2")))
    yaml = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        ROOT, "conf", "autoreg_physrnn.yaml")
    print(json.dumps(main(yaml)))
