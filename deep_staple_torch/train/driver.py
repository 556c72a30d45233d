"""Training driver: folds -> epochs -> train steps on the card
(`deep_staple_tpu/train/driver.py`, after `train_DL`,
`main_deep_staple.py:491-1086`).

The deterministic split (every atlas_count-th 3D index of the first
num_val_images fixed images is validation, :554-558), optional label
disturbance, the per-sample metric precompute (class weights, fixed
weighting), the epoch and batch loop with the reference's scheduler quirk
(ExponentialLR stepped per batch only in epochs where epx % atlas_count == 0,
:794-795), per-epoch validation at the eval scale, DP-Dice correlations,
periodic checkpoints and the train_label_snapshot export.

Random numbers: the host's numpy stream (`reset_determinism`) gives the
disturbed indices and the epoch permutations in the JAX driver's order, so
both packages split and order a run alike. The augmentation's small draws
(coins, affine matrices, control points, directions) come from one CPU
`torch.Generator` seeded by seed + 1000 * fold (the JAX driver's PRNG key,
:420) and are moved to the model's device, so a run on the card and one on
the CPU see the same warps. The two draws of a tensor's size, the image
noise (the batch's size) and the ASPP dropout mask (the ASPP output's), come
from a generator on the model's device seeded from the CPU one: drawn on the
host they would cost it more than the step's launches (about 0.5 s a
production step). `draws_on_host=True` takes those from the CPU generator
too, so that a run on any device sees every number of a run on the CPU.

With `use_2d_normal_to` it trains the 2D model on slices along that axis
(the training ids are the slices of the training volumes, the learning rate
follows the cosine warm restarts, validation scores full 3D volumes) and
exports a snapshot of slices; with `use_mind` the network sees MIND-SSC
features. With `save_dp_figures` it draws the DP scatter every 10 batches
and with `do_plot` the DP-sorted overview of the snapshot, where the JAX
driver does (`utils/visualization.py`; matplotlib and PIL on the host,
`check_supported` raises ImportError before any work where they are
missing). It resumes from its own checkpoints (`state.pt`) and from the JAX
package's `state.msgpack`.

Data parallelism (`mesh_data_axis` N > 1, `parallel/`): N processes, one
rank a device, in one process group (`main.maybe_init_distributed`). Every
rank runs the whole loop with the same seeds, so the split, the epoch
permutations and the augmentation's draws are the same on each; a batch
keeps a multiple of N rows, each rank loads its own contiguous block
(`host_shard_indices`) and keeps its rows of the global draws, and the step
reduces over the ranks (`train/step.py`), so that its metrics are the
global batch's and the state stays bitwise equal on every rank. The ranks
check that they resume alike, take rank 0's state, and wait for each other
before the first step of each step variant. Validation runs on every rank;
only rank 0 writes metrics, checkpoints, figures and the snapshot
(`driver.py:150-164`, `:322-337`, `:468-518`, `:596`, `:634`).

Pipeline parallelism (`mesh_pipe_stages=2`, one process): the two-stage
GPipe step (`parallel/pipeline.py`) with stage i on `cuda:(i mod visible
cards)` (both on one card here) or on the CPU, `pipe_microbatches` a batch
(the batch trimmed to a multiple), the slab warm-up step piped too; after
each epoch the model is placed back on stage 0's device for validation,
checkpoints and the snapshot (`driver.py:281-298`, `:378-417`, `:473-481`).

Tensor parallelism (`mesh_model_axis` M > 1, `parallel/tensor.py`): the
world is a grid of D x M ranks (D = `mesh_data_axis`), rank d * M + m, one
device a rank, where JAX runs the model axis over devices of one process
(`driver.py:255-276`, `:341-348`). A rank cuts its rows by its data index
d; after rank 0's state is on every rank, each takes its channel slice of
the sharded leaves and of AdamW's moments (`shard_train_state`). The
checkpoints hold the single-device layout, gathered over each model group
(every rank joins, rank 0 writes); validation and the snapshot's
predictions run on every rank through the sharded model, whose collectives
need them all, and rank 0 writes. The 2D model has no leaf that the rules
shard and runs replicated over the model group, as JAX's `shard_tp` leaves
it.

Spatial sharding (`mesh_space_axis` S > 1, `parallel/spatial.py`): the world
is a grid of D x S x M ranks, rank (d * S + s) * M + m, one device a rank,
where JAX shards the batch's H axis over devices of one process
(`driver.py:256-276`, `:486-492`). The S ranks of a space group load the
same rows (by their data index d) and keep the same rows of the global
draws; each warps its rows' whole volumes and the 3D model keeps a slab of
every volume's H axis (`train/step.py`). The input H of training and of
validation must leave every rank a row of the model's stride-4 grid
(`spatial.slab_map`); the driver checks both before any other work.
Validation, the slab warm-up model and the snapshot's predictions run on
every rank through the sharded model, whose exchanges need the whole
group, and rank 0 writes; the state is replicated over the space group, so
a checkpoint needs no gather there. The 2D model's slices are independent:
its D x S ranks form one data group (`parallel/mesh.py::batch_group`),
whose batch must divide by D x S, where JAX splits the slices' W axis.

A checkpoint is the port's `state.pt` or the JAX package's `state.orbax` or
`state.msgpack` (`train/checkpoint.py`); `checkpoint_backend` 'orbax'
writes `state.orbax`.
"""

from __future__ import annotations

import re
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from ..core.config import DataParamMode, TrainConfig
from ..core.determinism import reset_determinism
from ..core.device import resolve_device
from ..models import LRASPPMobileNetV3Large2D, MobileNetLRASPP3D, PlainConvUNet3D
from ..models.lraspp3d import attach_space_group
from ..ops.augment import AugmentDraws, AugmentParams, check_order, draw_augment
from ..ops.dice import batch_dice_over_all, batch_dice_per_class, dice_from_int_labels
from ..ops.resample import interpolate_sample
from ..parallel.mesh import batch_group, make_data_group, make_grid
from ..parallel.multihost import (
    check_resume_agrees, coordination_barrier, host_shard_indices, replicate_to_mesh,
)
from ..parallel.spatial import slab_map
from ..parallel.tensor import attach_model_group, gather_train_state, shard_train_state
from ..utils import tracing
from ..utils.logging import MetricWriter, get_global_idx, log_class_dices, log_data_parameter_stats
from .checkpoint import (
    check_backend, checkpoint_exists, restore_checkpoint, save_checkpoint,
)
from .optim import cosine_warm_restarts_lr, exp_lr
from .snapshot import export_train_label_snapshot
from .state import create_state
from .step import make_eval_step, make_train_step, rank_draws, resolve_augment_order


def dp_in_target_pos_ratio(dp_values, disturbed_idxs, target_pos: str = "min") -> float:
    """Fraction of disturbed samples found among the |disturbed| lowest (or
    highest) data parameters: the reference's oracle metric that DPs find
    corrupted labels (`calc_inst_parameters_in_target_pos_ratio`,
    main_deep_staple.py:320-333)."""
    assert target_pos in ("min", "max")
    disturbed_idxs = np.asarray(disturbed_idxs)
    if disturbed_idxs.size == 0:
        return float("nan")
    order = np.argsort(np.asarray(dp_values))
    if target_pos == "max":
        order = order[::-1]
    target = set(order[: len(disturbed_idxs)].tolist())
    return sum(1.0 for i in disturbed_idxs if int(i) in target) / len(disturbed_idxs)


def pearson_corr(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.std() == 0 or b.std() == 0:
        return float("nan")
    return float(np.corrcoef(a, b)[0, 1])


def spearman_corr(a, b):
    """Spearman rho without scipy: Pearson on tie-averaged ranks."""

    def _rank(x):
        _, inv, counts = np.unique(x, return_inverse=True, return_counts=True)
        csum = np.cumsum(counts) - 1
        start = csum - counts + 1
        return ((start + csum) / 2.0)[inv]

    return pearson_corr(_rank(np.asarray(a)), _rank(np.asarray(b)))


def make_model(config: TrainConfig, num_classes: int):
    """-> (model, input channels): the 2D LR-ASPP MobileNetV3 with
    `use_2d_normal_to` (which has no `bn_mode`: it says so and uses exact
    BatchNorm, `driver.py:75-89`), else the 3D model `model_arch` names."""
    in_ch = 12 if config.use_mind else 1
    dtype = torch.bfloat16 if config.compute_dtype == "bfloat16" else None
    if config.model_arch == "plainconvunet3d":
        return PlainConvUNet3D(num_classes=num_classes, in_channels=in_ch, dtype=dtype), in_ch
    if config.use_2d_normal_to is not None:
        if config.bn_mode != "batch":
            print(f"bn_mode {config.bn_mode!r} is a 3D-path lever; the 2D model "
                  "uses exact BatchNorm")
        return LRASPPMobileNetV3Large2D(num_classes=num_classes, dtype=dtype,
                                        in_channels=in_ch), in_ch
    model = MobileNetLRASPP3D(
        num_classes=num_classes,
        use_checkpointing=config.use_checkpointing,
        dtype=dtype,
        bn_mode=config.bn_mode,
        in_channels=in_ch,
    )
    return model, in_ch


def make_warmup_model(model, config: TrainConfig, num_classes: int):
    """The model of the first `bn_warmup_epochs` under async BatchNorm: the
    same network with slab BatchNorm, sharing every parameter and buffer
    (`count` included) with `model`, so that one optimizer and one set of
    running statistics serve both phases (`driver.py:393-418`), and its
    model group and space plan."""
    warm, _ = make_model(config.replace(bn_mode="slab"), num_classes)
    mods = dict(model.named_modules())
    for name, mod in warm.named_modules():
        mod._parameters = mods[name]._parameters
        mod._buffers = mods[name]._buffers
    if getattr(model, "tp", None) is not None:
        attach_model_group(warm, model.tp)
    if getattr(model, "space", None) is not None:
        attach_space_group(warm, model.space)
    return warm


def precompute_sample_metrics(dataset, train_idxs, num_classes: int, use_2d: bool, batch: int = 4,
                              device=None):
    """Per-sample Dice(label, modified label), gt voxel count and the class
    bincount at the x2.0 eval scale (reference :626-656, on eval-mode
    samples), on `device` (CUDA unless "cpu" is asked for)."""
    dev = resolve_device(device)
    n = len(dataset)
    wise_dice = np.zeros((n, num_classes), np.float32)
    gt_num = np.zeros((n,), np.float32)
    bn_count = np.zeros((num_classes,), np.int64)

    dataset.eval(use_modified=True)
    idx_list = [int(i) for i in train_idxs]
    for s in range(0, len(idx_list), batch):
        chunk = idx_list[s : s + batch]
        hb = dataset.sample_batch(chunk, use_modified=True)
        lbl = interpolate_sample(None, torch.from_numpy(hb["label"]).to(dev), 2.0, use_2d)[1]
        mod = interpolate_sample(None, torch.from_numpy(hb["modified_label"]).to(dev), 2.0, use_2d)[1]
        dsc = dice_from_int_labels(lbl, mod, num_classes, nan_for_unlabeled_target=False)
        gts = (mod > 0).reshape(len(chunk), -1).sum(dim=1).float()
        bn = torch.bincount(mod.reshape(-1).long(), minlength=num_classes)[:num_classes]
        wise_dice[chunk] = dsc.cpu().numpy()
        gt_num[chunk] = gts.cpu().numpy()
        bn_count += bn.cpu().numpy().astype(np.int64)

    class_weights = 1.0 / np.power(bn_count.astype(np.float64), 0.35)
    class_weights /= class_weights.mean()
    fixed_weighting = np.log(gt_num + np.e) + np.e
    return wise_dice, gt_num, bn_count, class_weights.astype(np.float32), fixed_weighting.astype(np.float32)


def _world_size() -> int:
    """The processes of this run: the default process group's size, or 1."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def check_supported(config: TrainConfig):
    """Raise for options that cannot run as configured, before any work:
    ValueError for data, space and model axes that do not match the
    processes (the space axis with pipeline stages raises in TrainConfig
    itself, as JAX's config does), and for a 2D batch that does not divide
    over data x space."""
    nproc = _world_size()
    if (config.dist_num_processes or 1) > 1 and nproc == 1:
        raise ValueError(
            f"dist_num_processes={config.dist_num_processes} but this process joined no process "
            "group: call main.maybe_init_distributed(config) first")
    D, S, M = config.mesh_data_axis, config.mesh_space_axis, config.mesh_model_axis
    ranks = D * S * M
    axes = " x ".join(f"mesh_{name}_axis={n}" for name, n in (("data", D), ("space", S),
                                                              ("model", M))
                      if n > 1 or (name == "data" and ranks > D))
    if nproc == 1 and ranks > 1:
        raise ValueError(
            f"{axes} runs one process a rank: launch {ranks} processes with "
            f"--dist-num-processes {ranks} (each with --dist-process-id and --dist-coordinator, "
            f"or under torchrun --nproc-per-node {ranks})")
    if nproc > 1:
        if config.mesh_pipe_stages > 1:
            raise ValueError(
                "mesh_pipe_stages > 1 is single-process only (stages are placed on explicit "
                "local devices)")
        if M == 1 and S == 1 and D % nproc:
            raise ValueError(
                f"mesh_data_axis={D} must divide over {nproc} processes "
                "(equal batch rows per host)")
        if ranks != nproc:
            raise ValueError(
                f"mesh_data_axis={D} x mesh_space_axis={S} x mesh_model_axis={M} over {nproc} "
                "processes: the port runs one device a rank, so data x space x model is the "
                "number of processes")
    if config.use_2d_normal_to is not None and S > 1 and config.batch_size % (D * S):
        raise ValueError(
            f"batch_size {config.batch_size} must divide by mesh_data_axis x mesh_space_axis = "
            f"{D * S}: the 2D model's slices are independent, so the space axis splits the "
            "batch's slices as the data axis does")
    check_order(config.augment_order)
    if config.save_dp_figures or config.do_plot:
        from ..utils.visualization import require_plotting

        require_plotting("save_dp_figures and do_plot")
    check_backend(config.checkpoint_backend)


def _to_device(host_batch: dict, dev: torch.device) -> dict:
    """Host arrays -> tensors on `dev`; through pinned memory to the card, so
    that the copy does not wait for the card's queue. Counts the bytes it
    copies to the card (`h2d_bytes`) and the pinned blocks it made the host
    allocator create (`pinned_allocs`) while tracing records."""
    pinned = dev.type == "cuda" and tracing.active() is not None
    allocs = _pinned_allocs() if pinned else 0
    out = {}
    for k, v in host_batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(v))
        if dev.type == "cuda" and t.device.type == "cpu":
            with tracing.span("to_device.pin"):
                t = t.pin_memory()
            with tracing.span("to_device.copy"):
                t = t.to(dev, non_blocking=True)
            tracing.count("h2d_bytes", t.nbytes)
        out[k] = t
    if pinned:
        tracing.count("pinned_allocs", _pinned_allocs() - allocs)
    return out


def _pinned_allocs() -> int:
    """Blocks the pinned host allocator has created so far."""
    return int(torch.cuda.host_memory_stats()["num_host_alloc"])


def _queue_readback(metrics: dict):
    """Start reading a step's loss and Dice back -> what `_read_back` takes.
    On the card: copies into pinned host tensors, queued right behind the
    step, and an event after them, so that the read waits for that step
    alone and not for the work queued since. Elsewhere: the tensors."""
    loss, dice = metrics["loss"], metrics["dice"]
    if not loss.is_cuda:
        return loss, dice, None
    host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
            for t in (loss, dice)]
    done = torch.cuda.Event()
    done.record(torch.cuda.current_stream(loss.device))
    return (*host, done)


def _read_back(pending) -> tuple:
    """-> (loss, Dice (B, C) array) of a `_queue_readback`. On the card it
    counts `readback_waited`: 1 where the copies had not completed when the
    read began, 0 where they had."""
    loss, dice, done = pending
    if done is not None:
        tracing.count("readback_waited", int(not done.query()))
        done.synchronize()
    return float(loss), dice.cpu().numpy()


def _resume_point(config: TrainConfig, run_name: str, fold_idx: int):
    """-> (first epoch, checkpoint path) of the JAX driver's resume rules
    (`driver.py:301-320`): an explicit checkpoint_epx re-runs that epoch from
    its checkpoint; auto_resume continues after the newest one. A checkpoint
    is the port's `state.pt` or the JAX package's `state.orbax` or
    `state.msgpack`."""
    epx_start = config.checkpoint_epx or 0
    ckpt_name = config.checkpoint_name or run_name
    prefix = Path(config.mdl_save_prefix)
    ckpt_path = prefix / f"{ckpt_name}_fold{fold_idx}_epx{epx_start}"
    if config.auto_resume and config.checkpoint_epx is None:
        pat = re.compile(rf"^{re.escape(ckpt_name)}_fold{fold_idx}_epx(\d+)$")
        newest = -1
        for d in prefix.glob(f"{ckpt_name}_fold{fold_idx}_epx*"):
            m = pat.match(d.name)
            if m and checkpoint_exists(d):
                newest = max(newest, int(m.group(1)))
        if newest >= 0:
            ckpt_path = prefix / f"{ckpt_name}_fold{fold_idx}_epx{newest}"
            epx_start = newest + 1
            print(f"Auto-resume: newest checkpoint {ckpt_path}, continuing at epoch {epx_start}")
    return epx_start, ckpt_path


def _start_profile(dev: torch.device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    prof = profile(activities=acts)
    prof.start()
    return prof


def train_dl(run_name: str, config: TrainConfig, dataset, atlas_count=None,
             writer: MetricWriter | None = None, device=None, draws_on_host: bool = False):
    """Train on `device` (CUDA unless "cpu" is asked for). Returns
    {fold: {"state", "snapshot_path", "train_idxs", "clean_idxs", "wise_dice",
    "writer"}}.

    While `utils/tracing.py` records, each batch's phases are spans of the
    batch's step number: `train.batch` (`sample_batch`), `train.draws`,
    `train.to_device`, `train.step` (the step call), `train.readback` (the
    previous step's metrics; on the card with its counter `readback_waited`),
    and each epoch's `train.checkpoint` and `train.validation`. With
    `profile_dir`, the profiled epoch's spans are recorded and written into
    its Chrome trace as a "program" process."""
    check_supported(config)
    use_2d = config.use_2d_normal_to is not None
    if config.mesh_space_axis > 1 and not use_2d:
        # Every rank of a space group needs a row of the model's stride-4
        # grid, at the training input's H and at validation's x2.0.
        H = dataset.get_3d_item(0)["image"].shape[1]
        for scale in (dataset.pre_interpolation_factor, 2.0):
            slab_map(int(H * scale), config.mesh_space_axis)
    dev = resolve_device(device)
    world = make_data_group(dev)  # every rank: the resume check, rank 0's state, barriers
    data, tp, space = make_grid(dev, config.mesh_model_axis, config.mesh_space_axis)
    if use_2d and space is not None:
        data = batch_group(dev, config.mesh_model_axis)  # the D x S ranks split the slices
    is_main = world is None or world.rank == 0
    if world is not None:
        print(f"Device mesh: data={config.mesh_data_axis} space={config.mesh_space_axis} "
              f"model={config.mesh_model_axis} over {world.size} processes")
    reset_determinism(config.seed)
    atlas_count = atlas_count if atlas_count is not None else config.atlas_count
    writer = writer or MetricWriter(
        jsonl_path=str(Path(config.output_dir) / f"{run_name}_metrics.jsonl")
        if config.log_jsonl and is_main else None,
    )

    use_dp = config.data_param_mode == DataParamMode.INSTANCE_PARAMS
    num_classes = len(dataset.label_tags)
    results = {}

    num_folds = 1 if config.only_first_fold or config.fold_override is not None else config.num_folds
    fold_range = (
        [config.fold_override] if config.fold_override is not None else list(range(num_folds))
    )

    for fold_idx in fold_range:
        epx_start, ckpt_path = _resume_point(config, run_name, fold_idx)
        if config.debug:
            num_val_images, fold_atlas_count = 2, 1
        else:
            num_val_images, fold_atlas_count = config.num_val_images, atlas_count

        all_len = dataset.__len__(use_2d_override=False)
        val_3d_idxs = list(range(0, min(num_val_images * fold_atlas_count, all_len), fold_atlas_count))
        train_3d_idxs = list(range(min(num_val_images * fold_atlas_count, all_len), all_len))
        if use_2d:
            # The slices of the training volumes (`driver.py:188-193`).
            train_3d = set(train_3d_idxs)
            train_2d_ids = [d["2d_id"] for d in dataset.get_id_dicts()
                            if d["3d_dataset_idx"] in train_3d and d["2d_id"] in dataset.label_data_2d]
            train_idxs = np.asarray(dataset.switch_2d_identifiers(train_2d_ids))
        else:
            train_idxs = np.asarray(train_3d_idxs)
        print(f"Fold {fold_idx}: {len(train_idxs)} train instances, {len(val_3d_idxs)} val images")

        # --- optional label disturbance (reference :564-587) ---
        if config.disturbed_percentage > 0.0:
            _, _, all_mod = dataset.get_data()
            sums = all_mod[train_idxs].reshape(len(train_idxs), -1).sum(-1)
            non_empty = train_idxs[sums > 0]
            k = int(len(non_empty) * config.disturbed_percentage)
            proposed = np.random.choice(non_empty, size=k, replace=False)
            dataset.disturb_idxs(
                proposed,
                disturbance_mode=config.disturbance_mode,
                disturbance_strength=config.disturbance_strength,
            )
        disturbed_bool_vect = np.zeros(len(dataset), np.float32)
        if dataset.disturbed_idxs:
            disturbed_bool_vect[np.asarray(dataset.disturbed_idxs)] = 1.0
        clean_idxs = train_idxs[~np.isin(train_idxs, dataset.disturbed_idxs)]
        print("Disturbed indexes:", sorted(dataset.disturbed_idxs))

        # --- per-sample metric precompute (reference :626-656) ---
        wise_dice, gt_num, bn_count, class_weights, fixed_weighting = precompute_sample_metrics(
            dataset, train_idxs, num_classes, use_2d, device=dev
        )

        # --- model + state ---
        model, _ = make_model(config, num_classes)
        dp_override_values = None
        if use_dp and config.override_embedding_weights:
            from ..data.snapshot_io import load_snapshot

            snap = load_snapshot(config.fixed_weight_file)
            ids = dataset.get_2d_ids() if use_2d else dataset.get_3d_ids()
            dp_override_values = np.zeros(len(dataset), np.float32)
            for _id, w in zip(snap["d_ids"], np.asarray(snap["data_parameters"]).reshape(-1)):
                if _id in ids:
                    dp_override_values[ids.index(_id)] = w

        state = create_state(
            model,
            dataset_len=len(dataset),
            seed=config.seed,
            init_inst_param=config.init_inst_param,
            use_data_params=use_dp,
            dp_override_values=dp_override_values,
            device=dev,
        )

        epx = max(epx_start - 1, 0)  # snapshot dir name if the loop is empty
        check_resume_agrees(epx_start, checkpoint_exists(ckpt_path), config.mdl_save_prefix,
                            world)
        if checkpoint_exists(ckpt_path):
            print(f"Restoring checkpoint from {ckpt_path}")
            state = restore_checkpoint(ckpt_path, state)
        state = shard_train_state(replicate_to_mesh(state, world), tp)
        pp_devices = None
        if config.mesh_pipe_stages > 1:
            from ..parallel.pipeline import make_pp_train_step, place_model, stage_devices

            pp_devices = stage_devices(dev)
            print(f"Pipeline parallelism: {config.mesh_pipe_stages} stages x "
                  f"{config.pipe_microbatches} microbatches on {[str(d) for d in pp_devices]}")

        pre_interp = dataset.pre_interpolation_factor
        effective_order = resolve_augment_order(config.augment_order, num_classes)
        if effective_order != config.augment_order:
            print(
                f"augment_order {config.augment_order!r} supports binary labels only; "
                f"using {effective_order!r} ({num_classes} classes)"
            )
            config = config.replace(augment_order=effective_order)
        check_order(config.augment_order)
        augment_params = AugmentParams()

        def build_step(step_model):
            if pp_devices is not None:
                return make_pp_train_step(
                    step_model, config, class_weights, fixed_weighting, augment_params,
                    pre_interpolation_factor=pre_interp, n_micro=config.pipe_microbatches,
                    devices=pp_devices)
            return make_train_step(step_model, config, class_weights, fixed_weighting,
                                   augment_params, pre_interpolation_factor=pre_interp, data=data,
                                   space=None if use_2d else space)

        train_step = build_step(model)
        eval_step = make_eval_step(model, config, num_classes, space=space)
        # Async-BN warmup: the first bn_warmup_epochs run the slab-BN model,
        # which shares every parameter and buffer with `model`
        # (`driver.py:393-418`); the 2D model has no bn_mode.
        warmup_step, warmup_epochs = None, 0
        if config.bn_mode == "async" and config.bn_warmup_epochs > 0 and not use_2d:
            warmup_epochs = config.bn_warmup_epochs
            warmup_step = build_step(make_warmup_model(model, config, num_classes))

        gen = torch.Generator().manual_seed(config.seed + 1000 * fold_idx)
        if draws_on_host:
            dev_gen = gen
        else:
            dev_gen = torch.Generator(device=dev)
            dev_gen.manual_seed(int(torch.randint(2**62, (1,), generator=gen)))
        t_start = time.time()
        sched_steps = int(state.sched_steps)
        started_steps = set()
        n_steps = 0

        for epx in range(epx_start, config.epochs):
            global_idx = get_global_idx(fold_idx, epx, config.epochs)
            dataset.train(use_modified=True)

            prof = None
            if config.profile_dir is not None and epx == config.profile_epoch:
                # The caller's recorder where one records, else one for the epoch.
                own_program = tracing.active() is None
                program = tracing.active() or tracing.record()
                program_since = program.now()
                prof = _start_profile(dev)

            perm = np.random.permutation(train_idxs)
            epx_losses, dices, class_dices = [], [], []

            # One-step-deferred metric readback (`driver.py:436-442`): step k's
            # loss and Dice are read after step k+1 is launched, so that the
            # host assembles the next batch while the card computes; on the
            # card from copies queued with step k (`_queue_readback`).
            pending_metrics = None

            def _consume(pending):
                loss, b_dice = _read_back(pending)
                epx_losses.append(loss)
                dices.append(batch_dice_over_all(b_dice, exclude_bg=True))
                class_dices.append(batch_dice_per_class(b_dice, dataset.label_tags, exclude_bg=True))

            for bstart in range(0, len(perm), config.batch_size):
                bidx = perm[bstart : bstart + config.batch_size]
                # A multiple of the data group, or of the microbatches.
                split = data.size if data is not None else (
                    config.pipe_microbatches if pp_devices is not None else 1)
                bidx = bidx[: len(bidx) // split * split]
                if len(bidx) == 0:
                    continue
                tracing.step(n_steps)
                n_steps += 1
                with tracing.span("train.batch"):
                    host_batch = dataset.sample_batch(
                        bidx if data is None else host_shard_indices(bidx, data.size, data.rank))
                with tracing.span("train.draws"):
                    # The global batch's draws; each rank keeps its rows.
                    draws = draw_augment(gen, (len(bidx),) + host_batch["image"].shape[1:],
                                         augment_params, pre_interp, noise_generator=dev_gen)
                    draws = rank_draws(draws, data)
                with tracing.span("train.to_device"):
                    batch = _to_device(host_batch, dev)
                    draws = AugmentDraws(*_to_device(draws._asdict(), dev).values())

                lr = (cosine_warm_restarts_lr(config.lr, sched_steps) if use_2d
                      else exp_lr(config.lr, sched_steps))
                step_fn = warmup_step if epx < warmup_epochs and warmup_step is not None else train_step
                if world is not None and id(step_fn) not in started_steps:
                    coordination_barrier(world)
                started_steps.add(id(step_fn))
                with tracing.span("train.step"):
                    state, metrics = step_fn(state, batch, lr, generator=dev_gen, draws=draws)
                metrics = _queue_readback(metrics)
                if pending_metrics is not None:
                    with tracing.span("train.readback"):
                        _consume(pending_metrics)
                pending_metrics = metrics

                # Scheduler quirk: step per batch when epx % atlas_count == 0 (:794-795).
                if config.use_scheduling and epx % fold_atlas_count == 0:
                    sched_steps += 1

                # DP scatter figures every 10 batches (`driver.py:530-545`,
                # reference :797-806).
                batch_no = bstart // config.batch_size
                if use_dp and config.save_dp_figures and is_main and batch_no % 10 == 0:
                    from ..utils.visualization import save_parameter_figure

                    train_params = state.dp_params.cpu().numpy()[train_idxs]
                    pcc = pearson_corr(train_params, wise_dice[train_idxs][:, 1])
                    fig_path = (
                        Path(config.output_dir) / f"{run_name}_fold{fold_idx}_figures"
                        / f"dp_figure_epx{epx:03d}_batch{batch_no:03d}.png"
                    )
                    save_parameter_figure(
                        fig_path, run_name,
                        f"corr. coeff. DP vs. dice(expert label, train gt): {pcc:4f}",
                        train_params, train_params / fixed_weighting[train_idxs],
                        wise_dice[train_idxs][:, 1],
                    )

                if config.debug:
                    break

            if pending_metrics is not None:
                with tracing.span("train.readback"):
                    _consume(pending_metrics)
            if pp_devices is not None:
                # Validation, checkpoints and the snapshot run on one device.
                place_model(state, pp_devices[0])

            if prof is not None:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                prof.stop()
                Path(config.profile_dir).mkdir(parents=True, exist_ok=True)
                trace = Path(config.profile_dir) / f"{run_name}_fold{fold_idx}_epx{epx}.trace.json"
                prof.export_chrome_trace(str(trace))
                program.add_chrome_track(trace, since=program_since)
                if own_program:
                    program.stop()
                print(f"profiler trace written to {trace}")

            state.sched_steps = sched_steps

            # --- epoch logging (reference :811-854) ---
            print(f"### Log epoch {epx} @ {time.time()-t_start:.2f}s")
            writer.log({"ref_epoch_idx": epx}, step=global_idx)
            writer.log({f"losses/loss_fold{fold_idx}": float(np.mean(epx_losses))}, step=global_idx)
            mean_dice = float(np.nanmean(dices))
            print(f"dice_mean_wo_bg_fold{fold_idx} {mean_dice*100:.2f}%")
            writer.log({f"scores/dice_mean_wo_bg_fold{fold_idx}": mean_dice}, step=global_idx)
            log_class_dices(writer, "scores/dice_mean_", f"_fold{fold_idx}", class_dices, global_idx)

            if use_dp:
                dp_host = state.dp_params.cpu().numpy()
                train_params = dp_host[train_idxs]
                order = np.argsort(train_params)
                target_dice = wise_dice[train_idxs][:, 1]
                pcc = pearson_corr(train_params[order], target_dice[order])
                scc = spearman_corr(train_params[order], target_dice[order])
                writer.log(
                    {
                        f"data_parameters/pearson_corr_coeff_fold{fold_idx}": pcc,
                        f"data_parameters/spearman_corr_coeff_fold{fold_idx}": scc,
                    },
                    step=global_idx,
                )
                log_data_parameter_stats(
                    writer, f"data_parameters/iter_stats_fold{fold_idx}", global_idx, dp_host
                )

            if (epx % config.save_every == 0) or (epx + 1 == config.epochs):
                with tracing.span("train.checkpoint"):
                    # The single-device layout, gathered over each model group.
                    full = state if tp is None else gather_train_state(
                        state, make_model(config, num_classes)[0])
                    if is_main:
                        _path = Path(config.mdl_save_prefix) / f"{run_name}_fold{fold_idx}_epx{epx}"
                        save_checkpoint(_path, full, config, backend=config.checkpoint_backend)
                    del full

            # --- validation (reference :876-955): always full 3D volumes ---
            dataset.eval()
            val_dices, val_class_dices = [], []
            with tracing.span("train.validation"):
                for val_idx in val_3d_idxs:
                    s3 = dataset.get_3d_item(val_idx)
                    val_batch = _to_device({
                        "image": s3["image"][None].astype(np.float32),
                        "label": s3["label"][None].astype(np.int32),
                    }, dev)
                    _, b_dice = eval_step(val_batch)
                    b_dice = b_dice.cpu().numpy()
                    val_dices.append(batch_dice_over_all(b_dice, exclude_bg=True))
                    val_class_dices.append(batch_dice_per_class(b_dice, dataset.label_tags,
                                                                exclude_bg=True))
            mean_val = float(np.nanmean(val_dices)) if val_dices else float("nan")
            print(f"val_dice_mean_wo_bg_fold{fold_idx} {mean_val*100:.2f}%")
            writer.log({f"scores/val_dice_mean_wo_bg_fold{fold_idx}": mean_val}, step=global_idx)
            log_class_dices(writer, "scores/val_dice_mean_", f"_fold{fold_idx}", val_class_dices, global_idx)

            if config.debug:
                break

        # --- snapshot export (reference :963-1045) ---
        snapshot_path = None
        if use_dp and not is_main and (tp is not None or (space is not None and not use_2d)):
            # The sharded model's predictions need every rank of its group.
            export_train_label_snapshot(None, state, model, config, dataset, train_idxs,
                                        disturbed_bool_vect, save_labels=config.save_labels)
        if use_dp and is_main:
            snapshot_path = (
                Path(config.output_dir) / f"{run_name}_fold{fold_idx}_epx{epx}" / "train_label_snapshot.npz"
            )
            snapshot = export_train_label_snapshot(
                snapshot_path, state, model, config, dataset, train_idxs, disturbed_bool_vect,
                save_labels=config.save_labels,
            )
            if config.export_pth_snapshot:
                from ..data.snapshot_io import save_snapshot_pth

                save_snapshot_pth(snapshot_path.with_suffix(".pth"), snapshot)
            # The DP-sorted overview (`driver.py:650-660`; the reference
            # builds it at :1047-1084 and disables it, :1057).
            if config.do_plot and config.save_labels and len(train_idxs) <= 150:
                from ..utils.visualization import visualize_seg

                overlay = [f"id:{d} dp:{float(w):.2f}"
                           for d, w in zip(snapshot["d_ids"], snapshot["data_parameters"])]
                preds = snapshot["train_predictions"]
                visualize_seg(
                    in_type="batch_3D", reduce_dim="W", img=snapshot["labels"],
                    seg=4 * (preds[:, None].squeeze(1) if preds.ndim == 4 else preds),
                    ground_truth=snapshot["modified_labels"], overlay_text=overlay,
                    annotate_color=(255, 0, 0),  # red disturb markers
                    frame_elements=list(snapshot["disturb_flags"]), n_per_row=70,
                    file_path=snapshot_path.parent / "data_parameter_weighted_samples.png",
                )

        results[fold_idx] = {
            "state": state,
            "snapshot_path": snapshot_path,
            "train_idxs": train_idxs,
            "clean_idxs": clean_idxs,
            "wise_dice": wise_dice,
            "writer": writer,
        }

    return results
