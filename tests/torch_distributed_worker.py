"""One process of tests/test_torch_distributed.py's gloo group.  It imports
the port and no JAX.

    python tests/torch_distributed_worker.py smoke  HOST:PORT PROCESSES RANK
    python tests/torch_distributed_worker.py fanout HOST:PORT PROCESSES RANK WORK_DIR
    python tests/torch_distributed_worker.py dataparallel HOST:PORT PROCESSES RANK
    python tests/torch_distributed_worker.py recover WORK_DIR MEMBERS_JSON SENTINEL_DIR

Every mode joins the group (`parallel.distributed.initialize_distributed`),
takes this process's `my_member_assignments` (5 folds for `smoke`, 3
otherwise) and all-reduces rank + 1 over gloo.  `fanout` then trains its
members into the shared, prepared WORK_DIR with `orchestration.train_member`
(the counterpart of tests/_distributed_ensemble_worker.py): width-0.125
C3Ds at 16×32², 1 epoch, f32 on the CPU, each from a seeded draw.
`dataparallel` (the counterpart of tests/_distributed_worker.py:68-113)
takes one data-parallel step whose data axis spans the group: this process
holds its rows of a global batch of 8 on a mesh of 2 CPU positions, and the
BatchNorm sums and gradients are summed over the processes
(`parallel.distributed.ProcessSum`); then it takes the one-process step on
the whole global batch from the same start.  A width-0.125 R3D-18 at
16×32² in float64, augment on.  The process leaves the group before it
exits and prints ONE JSON line: {"process_id", "processes",
"multi_process", "assignments", "all_reduce", "trained"} and, for
`dataparallel`, "step": {"loss", "one_process_loss", "digest",
"max_abs_diff"}.  `recover` (the counterpart of tests/_recovery_worker.py)
joins no group: it trains the given members of the prepared WORK_DIR one
after another as `fanout` does, writing SENTINEL_DIR/started_<t>_<v>
before each and done_<t>_<v> after, so that the test can kill it while it
trains a member.
"""

from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "crowded_scenes_ensemble_classification_tpu_torch"
CLASSES, FOLDS, CLIP_THW, STAGING = 3, 3, (16, 32, 32), (40, 40)


def tiny_c3d(seed: int, trainable: bool):
    """A width-0.125 C3D bundle at 16×32², weights drawn from `seed`."""
    import torch

    from crowded_scenes_ensemble_classification_tpu_torch.core.config import ClipSpec
    from crowded_scenes_ensemble_classification_tpu_torch.models.c3d import C3D
    from crowded_scenes_ensemble_classification_tpu_torch.models.registry import ModelBundle

    module = C3D(CLASSES, width=0.125, clip_thw=CLIP_THW, generator=torch.Generator().manual_seed(seed))
    return ModelBundle("C3D", module if trainable else module.eval(), ClipSpec(*CLIP_THW), CLASSES, False,
                       trainable=trainable)


def fanout_config():
    from crowded_scenes_ensemble_classification_tpu_torch.core.config import ExperimentConfig

    return ExperimentConfig(model_type="C3D", training_condition="_SCRATCH", folds_number=FOLDS,
                            num_classes=CLASSES, batch_size=6, epochs=1, compute_dtype="float32")


def train_assignments(work_dir: str, assignments) -> list:
    from crowded_scenes_ensemble_classification_tpu_torch import orchestration as orch

    config, layout = fanout_config(), orch.WorkLayout(work_dir)
    bundle = tiny_c3d(0, trainable=True)
    trained = []
    for t, v in assignments:
        start = tiny_c3d(1000 * t + v, trainable=True).module.state_dict()
        out = orch.train_member(config, layout, t, v, epochs=1, bundle=bundle, initial_variables=start,
                                input_scale=1 / 255.0, staging_hw=STAGING, num_workers=2, device="cpu")
        trained.append([t, v, float(out["test_loss"])])
    return trained


def data_parallel_step(rank: int, processes: int) -> dict:
    """The cross-process step against the one-process step (module
    docstring): its loss, the one-process loss, a digest of the updated
    weights and running statistics (sha256 of their bytes) and their max
    |Δ| from the one-process step's."""
    import copy
    import hashlib

    import numpy as np
    import torch

    from crowded_scenes_ensemble_classification_tpu_torch.core.config import ClipSpec
    from crowded_scenes_ensemble_classification_tpu_torch.core.mesh import make_mesh
    from crowded_scenes_ensemble_classification_tpu_torch.models.r3d import R3D
    from crowded_scenes_ensemble_classification_tpu_torch.models.registry import ModelBundle
    from crowded_scenes_ensemble_classification_tpu_torch.parallel.distributed import ProcessSum
    from crowded_scenes_ensemble_classification_tpu_torch.train import TrainState, keras_sgd, make_train_step

    rng = np.random.default_rng(7)  # the same global batch in every process
    batch = {"rgb": rng.integers(0, 256, (8, 16, 40, 40, 3), dtype=np.uint8),
             "label": rng.integers(0, CLASSES, 8).astype(np.int32), "valid": np.arange(8) != 3}
    module = R3D(CLASSES, 18, 0.125, generator=torch.Generator().manual_seed(3)).double()
    bundles = [ModelBundle("R3D_18", m, ClipSpec(*CLIP_THW), CLASSES, False, trainable=True)
               for m in (module, copy.deepcopy(module))]
    tx = keras_sgd(0.01)
    cw = torch.tensor([0.5, 1.0, 2.0], dtype=torch.float64)
    half = 8 // processes
    mine = {k: v[rank * half:(rank + 1) * half] for k, v in batch.items()}
    mesh = make_mesh((("data", 2),), [torch.device("cpu")] * 2)
    step = make_train_step(bundles[0], tx, CLIP_THW[1:], True, input_scale=1 / 255.0, mesh=mesh,
                           processes=ProcessSum())
    _, metrics = step(TrainState.create(bundles[0].module, tx, seed=5), mine, cw)
    alone = make_train_step(bundles[1], tx, CLIP_THW[1:], True, input_scale=1 / 255.0)
    _, reference = alone(TrainState.create(bundles[1].module, tx, seed=5), batch, cw)
    got, want = (b.module.state_dict() for b in bundles)
    digest = hashlib.sha256(b"".join(v.numpy().tobytes() for v in got.values())).hexdigest()
    diff = max((got[k] - want[k]).abs().max().item() for k in want if want[k].is_floating_point())
    return {"loss": float(metrics["loss"]), "one_process_loss": float(reference["loss"]), "digest": digest,
            "max_abs_diff": diff}


def recover_worker(work_dir: str, members: list, sentinels: str) -> None:
    for t, v in members:
        open(os.path.join(sentinels, f"started_{t}_{v}"), "w").close()
        train_assignments(work_dir, [(t, v)])
        open(os.path.join(sentinels, f"done_{t}_{v}"), "w").close()


def main() -> None:
    sys.path.insert(0, REPO)
    if sys.argv[1] == "recover":
        import torch

        torch.set_num_threads(1)
        recover_worker(sys.argv[2], json.loads(sys.argv[3]), sys.argv[4])
        print(json.dumps({"done": json.loads(sys.argv[3])}))
        return
    mode, coordinator, processes, rank = sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4])
    import torch

    torch.set_num_threads(1)
    from crowded_scenes_ensemble_classification_tpu_torch.parallel import distributed

    distributed.initialize_distributed(coordinator, processes, rank, timeout_s=60)
    try:
        assignments = distributed.my_member_assignments(5 if mode == "smoke" else FOLDS)
        total = torch.tensor([rank + 1.0])
        torch.distributed.all_reduce(total)
        record = {"process_id": rank, "processes": distributed.process_count_index()[0],
                  "multi_process": distributed.is_multi_process(), "assignments": assignments,
                  "all_reduce": float(total.item()), "trained": []}
        if mode == "fanout":
            record["trained"] = train_assignments(sys.argv[5], assignments)
            torch.distributed.barrier()  # both members' sets are on disk before either leaves
        if mode == "dataparallel":
            record["step"] = data_parallel_step(rank, processes)
    finally:
        distributed.shutdown_distributed()
    print(json.dumps(record))


if __name__ == "__main__":
    main()
