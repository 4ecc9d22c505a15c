"""Print how far the port's training steps part from the JAX trainer's.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_train_gaps.py

The measurements behind ``tests/test_torch_train.py``'s bounds and its
two ``xfail`` reasons, on the CPU at the smoke size (about two minutes):

* chained: each case of ``test_three_steps_track_jax``, with each step's
  grad-norm gap and the parameters' distance from JAX over the distance
  they moved;
* each step from JAX's state (``_each_step``): the update's gap and each
  optimizer moment's, for the bf16 accumulator and the HT sync with
  stragglers;
* the witness (``_jax_parted``): JAX against itself with step 1's
  parameters moved by the port's step-1 gap, one reading a seed.

It prints one JSON object.
"""
import json
import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_train as T                                  # noqa: E402


def main() -> int:
    T.torch.set_num_threads(1)
    out = {"chained": {}, "each_step": {}, "jax_parted": {}}
    for case in T._three_steps_cases():
        name, (arch, opt, accum, keep, sync, master) = case.id, case.values
        with pytest.MonkeyPatch.context() as mp:
            run, jrun = T._both_runs(arch, opt, accum, master, sync, mp)
            metrics, _, parted = T._chained(run, jrun, keep)
        out["chained"][name] = {
            "grad_norm_gap": [abs(a / b - 1) for a, b in
                              (m["grad_norm"] for m in metrics)],
            "parted": float(parted)}
    for case, (opt, accum, master, sync, keep) in T.GAP_CASES.items():
        with pytest.MonkeyPatch.context() as mp:
            run, jrun = T._both_runs("smollm-360m", opt, accum, master,
                                     sync, mp)
            recs = T._each_step(run, jrun, keep)
            out["each_step"][case] = [
                {"update": r["update"], "moments": r["moments"]}
                for r in recs]
            out["jax_parted"][case] = [float(x) for x in T._jax_parted(
                run, jrun, keep, recs[1]["update"])]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
