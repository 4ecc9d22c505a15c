"""Print how far tensor-parallel training parts from one process.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/torch_tp_gaps.py

The measurements behind ``tests/test_torch_train_mesh.py``'s step-by-step
comparison on its 2 x 2 mesh, on the CPU at the smoke size (about three
minutes): for each case of that module, the parameters' distance from
the port's single-process steps over the distance they moved
(``_parted``), in the port's float32 arithmetic,

* chained (three steps), on the (2,) data mesh and on the (2, 2) mesh
  whose "model" axis splits the products;
* each step alone on (2, 2), started from one process's state before it
  (step 0's lr is 0, so it moves nothing and is left out).

It prints one JSON object.
"""
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import test_torch_train_mesh as T                             # noqa: E402

from repro_torch.distributed.spawn import run_ranks          # noqa: E402


def _single(states) -> dict:
    """The port's single-process three steps, a case each, as the test
    module's ``single`` fixture gives them."""
    from repro_torch.models.convert import from_jax_train_state
    from repro_torch.train import compression
    out = {}
    for name, (arch, opt, accum, keep, sync) in T.CASES.items():
        run = T.smoke_run(arch, opt, accum, sync)
        state = from_jax_train_state(run, states[name][1], device="cpu")
        before = []
        with T._sync_mode(sync, compression):
            out[name] = T._three_steps(run, state, keep, before=before) + (
                before,)
    return out


def main() -> int:
    from repro_torch.models.common import tree_leaves

    torch.set_num_threads(1)
    states = T._init_states()
    np_states = {k: v[1] for k, v in states.items()}
    single = _single(states)
    out = {"chained": {}, "each_step_2x2": {}}
    for mesh in ("data2", "data2x2"):
        shape = T.MESHES[mesh]
        ranks = run_ranks(T._mesh_cases, int(np.prod(shape)), shape,
                          np_states, device="cpu", timeout_s=300)
        out["chained"][mesh] = {name: float(T._parted(
            ranks[0][name][1], single[name][1],
            T._init_params(states, name))) for name in T.CASES}
    each = run_ranks(T._each_step_cases, 4, (2, 2),
                     {name: single[name][2] for name in T.CASES},
                     device="cpu", timeout_s=300)[0]
    for name in T.CASES:
        params = [[np.asarray(x) for x in tree_leaves(b.params)]
                  for b in single[name][2]] + [single[name][1]]
        out["each_step_2x2"][name] = [float(T._parted(
            each[name][i][1], params[i + 1], params[i])) for i in (1, 2)]
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
