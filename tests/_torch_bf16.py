"""The bf16 cases of the tensor-parallel schedules past 1x1, shared by the
port's gloo worlds (``tests/_torch_dist_worker.py``, case ``bf16``), the
reference's own schedules on XLA's host devices
(``tests/_jax_mesh_worker.py``) and the tests that compare them
(``tests/test_torch_distributed.py``,
``tests/test_torch_distributed_families.py``).  Imports neither JAX nor a
package of the repository (numpy alone): the functions take either
package's ``configs.base`` and ``distributed.sharding`` modules.

Each case runs at ``reduce_config`` widths with bf16 compute, as the
launchers run by default: a training case with f32 parameters (the
training default), a serving case under ``make_serve_config`` (bf16
parameters), the MoE without drops (``capacity_factor=100``) so that
routing, not capacity, decides every token.

The bounds: the loss within rtol ``LOSS_RTOL``, each gradient leaf
within ``LEAF_ATOL`` of its largest value, greedy tokens equal on at
least ``TOKENS_AGREE`` of them; the tokens are compared both free-running
(``greedy_generate``) and teacher-forced (each step's argmax after the
same prefix, so that one flip does not carry into the steps after it).

The port's mesh run is held at those bounds against the port's
unsharded bf16 run.  Its sharded step rounds where the one-device step
rounds: each rank's part of a split product, forward or backward, is
summed over the mesh in f32 and rounded once (``layers.dense_rows``,
``layers.dense_cols``, ``parallel.copy_to_f32``).

Against the reference's own bf16 schedule on the same mesh, the leaf and
token bounds are held beyond a *noise floor*.  bf16 rounding alone puts
two correct runs of these models farther apart than those bounds: the
reference's mesh run and its one-device run disagree past them, and so
do the two frameworks on one device
(``test_reference_bf16_schedules_disagree_past_the_bounds``; ROADMAP
queue 3).  The floor is ``a + b``, read in the same test from runs that
involve no sharding of the port: ``a``, the reference's mesh run against
its one-device run, and ``b``, the port's one-device run against the
reference's (for the leaves, the largest error of any leaf relative to
its largest value; for the tokens, the share that differ).  Each part
must stay under its ceiling, 1.5 times its reading on these inputs
(``LEAF_READINGS``, ``TOKEN_READINGS``; a token ceiling also allows two
more flips), so that a fault in either one-device run fails the test
instead of widening the bound.  The reference's processes run XLA on one
thread per device (``XLA_FLAGS``), so its sums, and ``a``, do not depend
on the host's core count.
"""
import dataclasses
import types

import numpy as np

#: the reference's processes: XLA's 8 host devices, each computing on one
#: thread, so that its sums (and the floors read from them) do not change
#: with the host's core count
XLA_FLAGS = ("--xla_force_host_platform_device_count=8 "
             "--xla_cpu_multi_thread_eigen=false "
             "intra_op_parallelism_threads=1")
LOSS_RTOL = 2e-2
LEAF_ATOL = 1e-2
TOKENS_AGREE = 0.99
SEP = "|"
#: the ceiling on a floor part: this many times its reading
CEILING = 1.5

#: the serve cases' prompts and new tokens (greedy_generate: a prefill
#: and NEW - 1 decode steps; teacher-forced: the same steps fed ``feed``)
SERVE_B, SERVE_S, NEW = 8, 8, 16
TRAIN_B, TRAIN_S = 8, 16

#: (tag, arch, mesh dims, mode): the loss and every gradient leaf
#: (DeepSeek's MoE layers run ``_moe_tp_psum`` on 2x4)
TRAIN = (
    ("olmo_2x4_train", "olmo-1b", (2, 4), "train"),
    ("olmo_2x4_dp_train", "olmo-1b", (2, 4), "dp_train"),
    ("olmo_1x2_train", "olmo-1b", (1, 2), "train"),
    ("smollm_2x4_train", "smollm-135m", (2, 4), "train"),
    ("deepseek_2x4_train", "deepseek-v2-lite-16b", (2, 4), "train"),
    ("falcon_2x2_train", "falcon-mamba-7b", (2, 2), "train"),
    ("zamba2_2x2_train", "zamba2-1.2b", (2, 2), "train"),
)
#: (tag, arch, mesh dims): greedy_generate's tokens under SERVE_RULES_1POD
SERVE = (
    ("olmo_2x4_serve", "olmo-1b", (2, 4)),
    ("olmo_1x2_serve", "olmo-1b", (1, 2)),
    ("smollm_2x4_serve", "smollm-135m", (2, 4)),
    ("deepseek_2x4_serve", "deepseek-v2-lite-16b", (2, 4)),
    ("falcon_1x4_serve", "falcon-mamba-7b", (1, 4)),
    ("zamba2_1x4_serve", "zamba2-1.2b", (1, 4)),
)
#: (a, b) of each training case's leaf floor, read on these inputs (the
#: port's worlds and the reference's pinned processes on the CPU)
LEAF_READINGS = {
    "olmo_2x4_train": (0.0169, 0.0196),
    "olmo_2x4_dp_train": (0.0061, 0.0196),
    "olmo_1x2_train": (0.0169, 0.0196),
    "smollm_2x4_train": (0.0150, 0.0181),
    "deepseek_2x4_train": (0.0265, 0.0225),
    "falcon_2x2_train": (0.0167, 0.0321),
    "zamba2_2x2_train": (0.0774, 0.0822),
}
#: (a, b) of each serving case's token floor, teacher-forced and free
TOKEN_READINGS = {
    ("olmo_2x4_serve", True): (0.0078, 0.0078),
    ("olmo_2x4_serve", False): (0.0, 0.0),
    ("olmo_1x2_serve", True): (0.0234, 0.0078),
    ("olmo_1x2_serve", False): (0.0, 0.0),
    ("smollm_2x4_serve", True): (0.0078, 0.0156),
    ("smollm_2x4_serve", False): (0.0859, 0.1875),
    ("deepseek_2x4_serve", True): (0.0312, 0.0234),
    ("deepseek_2x4_serve", False): (0.3516, 0.1719),
    ("falcon_1x4_serve", True): (0.0234, 0.0391),
    ("falcon_1x4_serve", False): (0.0859, 0.1016),
    ("zamba2_1x4_serve", True): (0.0078, 0.0312),
    ("zamba2_1x4_serve", False): (0.2188, 0.5078),
}
#: the families' cases run in the 4-rank world of
#: ``tests/test_torch_distributed_families.py``, the rest in the 8- and
#: 2-rank worlds of ``tests/test_torch_distributed.py``
FAMILY_ARCHS = ("falcon-mamba-7b", "zamba2-1.2b")


def world_of(dims) -> int:
    return int(np.prod(dims))


def cases(world: int, families: bool) -> tuple:
    """(train cases, serve cases) of one world."""
    def mine(arch, dims):
        return world_of(dims) == world and (arch in FAMILY_ARCHS) == families

    return ([c for c in TRAIN if mine(c[1], c[2])],
            [c for c in SERVE if mine(c[1], c[2])])


def mesh_like(dims):
    """A described ``("data", "model")`` mesh of ``dims``: what the spec
    functions read (``.shape``, ``.axis_names``)."""
    return types.SimpleNamespace(shape=dict(zip(("data", "model"), dims)),
                                 axis_names=("data", "model"))


def train_config(base, arch: str):
    """``arch`` reduced, f32 parameters and bf16 compute."""
    cfg = dataclasses.replace(base.reduce_config(base.get_config(arch)),
                              param_dtype="float32", compute_dtype="bfloat16")
    if cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=100.0))
    return cfg


def serve_config(base, sharding, arch: str, dims):
    """``make_serve_config`` of ``train_config`` for the model axis (bf16
    parameters), the SSM and hybrid families under
    ``choose_serve_cache_policy``, as the families' serve tests place
    them."""
    cfg = base.make_serve_config(train_config(base, arch), dims[1])
    if cfg.family in ("ssm", "hybrid"):
        cfg = dataclasses.replace(
            cfg, **sharding.choose_serve_cache_policy(cfg, mesh_like(dims)))
    return cfg


def weights_key(arch: str) -> str:
    """The prefix of ``arch``'s weights in ``in.npz``."""
    return f"bf16w_{arch}"


def inputs(cfg, arch: str, rng) -> dict:
    """numpy training tokens and targets and serving prompts of ``arch``."""
    toks = rng.integers(0, cfg.vocab, (TRAIN_B, TRAIN_S + 1), dtype=np.int32)
    return {f"bf16_{arch}_tokens": toks[:, :-1],
            f"bf16_{arch}_targets": toks[:, 1:],
            f"bf16_{arch}_prompt": rng.integers(
                0, cfg.vocab, (SERVE_B, SERVE_S), dtype=np.int32),
            f"bf16_{arch}_feed": rng.integers(
                0, cfg.vocab, (SERVE_B, NEW - 1), dtype=np.int32)}


def agreement(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float((a == b).mean())


def leaf_errors(got: dict, want: dict) -> dict:
    """Each leaf's largest error over its largest reference value."""
    assert sorted(got) == sorted(want), (sorted(got), sorted(want))
    return {n: float(np.abs(got[n] - w).max() / max(np.abs(w).max(), 1e-30))
            for n, w in want.items()}


def grads_of(run: dict, key: str) -> dict:
    prefix = f"{key}{SEP}grad{SEP}"
    return {k[len(prefix):]: v for k, v in run.items() if k.startswith(prefix)}


def worst_leaf(got: dict, want: dict) -> tuple:
    """(name, error) of the leaf farthest from ``want`` (``leaf_errors``)."""
    errors = leaf_errors(got, want)
    name = max(errors, key=errors.get)
    return name, errors[name]


def leaf_floors(tag: str, port_one: dict, ref: dict) -> tuple:
    """(a, b) of a training case: the largest leaf error of the
    reference's mesh run against its one-device run, and of the port's
    one-device run against the reference's."""
    one = grads_of(ref, f"one{SEP}{tag}")
    return (worst_leaf(grads_of(ref, tag), one)[1],
            worst_leaf(grads_of(port_one, f"one{SEP}{tag}"), one)[1])


def greedy(run: dict, key: str, forced: bool) -> np.ndarray:
    """The greedy tokens [B, NEW] of a serving run: teacher-forced (the
    argmax of each step's logits) or free-running."""
    if forced:
        return run[f"{key}{SEP}forced"].argmax(-1)
    return run[f"{key}{SEP}tokens"]


def token_floors(tag: str, port_one: dict, ref: dict, forced: bool) -> tuple:
    """(a, b) of a serving case: the share of tokens that differ between
    the reference's mesh run and its one-device run, and between the
    port's one-device run and the reference's."""
    one = greedy(ref, f"one{SEP}{tag}", forced)
    return (1 - agreement(greedy(ref, tag, forced), one),
            1 - agreement(greedy(port_one, f"one{SEP}{tag}", forced), one))


def leaf_ceilings(tag: str) -> tuple:
    """The ceilings on (a, b) of a training case's leaf floor."""
    return tuple(CEILING * r for r in LEAF_READINGS[tag])


def token_ceilings(tag: str, forced: bool) -> tuple:
    """The ceilings on (a, b) of a serving case's token floor: CEILING
    times the reading, and two more flips."""
    return tuple(CEILING * r + 2 / (SERVE_B * NEW)
                 for r in TOKEN_READINGS[(tag, forced)])
