"""Print how far the tensor-parallel first-step gradients part from one
process, leaf by leaf, and how far one process's own gradients move under
a perturbation of a few float32 ulps.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_tp_grad_gaps.py

The measurements behind ``tests/test_torch_tp.py``'s ``GRAD_BOUND``, on
the CPU at the smoke size (about three minutes), for each ``TRAIN`` case
of that module, as ``test_tp_gradients_match_one_process`` reads them
(each leaf's largest gap over its largest entry):

* ``split``: the first step's gradients on the (1, 2) and (2, 2) meshes
  against one process's, the six leaves that part most;
* ``perturbed``: one process's gradients with every embedding row scaled
  by 1 + 2^-22 against one process's, the four leaves that move most:
  how strongly the model's gradient answers a change of its inputs at
  the size of float32 rounding, which the split's reordered sums make.

It prints one JSON object.
"""
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_tp as T                                     # noqa: E402
from test_torch_train_mesh import _named_leaves               # noqa: E402

from repro_torch.distributed.spawn import run_ranks          # noqa: E402

SCALE = 1 + 2.0 ** -22


def _gaps(got, want, paths, top) -> dict:
    gaps = sorted(((float(np.abs(g - w).max() / max(np.abs(w).max(),
                                                      1e-30)), p)
                   for p, g, w in zip(paths, got, want)), reverse=True)
    return {p: g for g, p in gaps[:top]}


def _split_grads(_mesh, shape, states):
    from repro_torch.models.convert import from_jax_train_state
    torch.set_num_threads(1)
    out = {}
    for name in T.TRAIN:
        run = T.train_run(name)
        state = from_jax_train_state(run, states[name], device="cpu")
        out[name] = T._first_grads(run, state, T._mesh(shape))
    return out


def main() -> int:
    from repro_torch.models.convert import from_jax_train_state

    torch.set_num_threads(1)
    states = {k: v[1] for k, v in T._jax_states().items()}
    one, paths, out = {}, {}, {"split": {}, "perturbed": {}}
    for name in T.TRAIN:
        run = T.train_run(name)
        state = from_jax_train_state(run, states[name], device="cpu")
        paths[name] = [p for p, _ in _named_leaves(state.params)]
        one[name] = T._first_grads(run, state)
        state = from_jax_train_state(run, states[name], device="cpu")
        with torch.no_grad():
            state.params["embed"]["tok"].mul_(SCALE)
        out["perturbed"][name] = _gaps(T._first_grads(run, state),
                                       one[name], paths[name], 4)
    for shape in ((1, 2), (2, 2)):
        got = run_ranks(_split_grads, int(np.prod(shape)), shape, states,
                        device="cpu", timeout_s=600)[0]
        out["split"]["x".join(map(str, shape))] = {
            name: _gaps(got[name], one[name], paths[name], 6)
            for name in T.TRAIN}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
