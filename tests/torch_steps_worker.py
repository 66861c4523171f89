"""One rank of ``tests/test_torch_steps.py``'s multi-rank runs (a helper
module, not collected): the port's sharded train step on a gloo mesh, the
weights and tokens from the test's files, rank 0's results pickled.

  python tests/torch_steps_worker.py RANK WORLD MESH ARCH COMPRESSION STEP WEIGHTS TOKENS RDV OUT
"""
import pickle
import sys

import numpy as np
import torch

from repro_torch.configs import resolve_config
from repro_torch.configs.base import RunConfig, ShapeConfig
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import steps as tsteps
from repro_torch.models.params import from_numpy_tree, tree_leaves, tree_map
from repro_torch.training import optimizer as topt
from repro_torch.training.compression import init_error_state
from repro_torch.training.train_state import make_train_state

B, S, BLK = 4, 32, 16
OPT = dict(learning_rate=1e-3, warmup_steps=1, total_steps=3)


def full(t):
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach().float().numpy()


def main(rank, world, mesh_shape, arch, comp, step, weights, tokens, rdv, out):
    torch.set_num_threads(1)
    names = ("pod", "data", "model")[-len(mesh_shape):]
    cfg = resolve_config(arch)
    run = RunConfig(attn_q_block=BLK, attn_kv_block=BLK, grad_compression=comp)
    opt = topt.OptConfig(**OPT)
    with tmesh.process_group("cpu", rank=rank, world_size=world, init_method=rdv):
        mesh = tmesh.make_mesh(mesh_shape, names, "cpu")
        fn, _, in_pl, _, n_micro, rules = tsteps.make_train_step(
            cfg, ShapeConfig("t", "train", S, B), mesh, run, opt)
        with open(weights, "rb") as f:
            state = make_train_state(from_numpy_tree(pickle.load(f), "cpu"), opt)
        state["step"] = step
        if comp == "int8_ef":
            state["ef_err"] = init_error_state(state["params"])
        state = tsteps.distribute_tree(state, in_pl[0], mesh)
        for leaf in tree_leaves(state["params"]):
            leaf.requires_grad_(True)
        batch = tsteps.distribute_tree({"tokens": torch.from_numpy(np.load(tokens))},
                                       in_pl[1], mesh)
        new, metrics = fn(state, batch)
        res = {"loss": full(metrics["loss"]),
               "grid": tuple(tsteps.dispatch_grid(mesh, rules)), "n_micro": n_micro,
               "params": tree_map(new["params"], full),
               "mu": tree_map(new["opt"]["mu"], full), "nu": tree_map(new["opt"]["nu"], full)}
    if rank == 0:
        with open(out, "wb") as f:
            pickle.dump(res, f)


if __name__ == "__main__":
    a = sys.argv[1:]
    main(int(a[0]), int(a[1]), tuple(int(x) for x in a[2].split(",")), a[3], a[4], int(a[5]),
         a[6], a[7], a[8], a[9])
