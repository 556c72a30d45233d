"""Configuration: the port's own copy of `deep_staple_tpu.core.config`.

The same fields, enums and JSON form as the JAX package's `TrainConfig`, so a
`config.json` written by either package reads in the other
(`from_dict` ignores keys it does not know). The field comments of the JAX
package explain each knob; only the port's differences are noted here.

The port's own field `model_arch` selects the 3D network: 'lraspp3d'
(MobileNet-LRASPP-3D, the JAX package's) or 'plainconvunet3d' (nnU-Net v2's
`PlainConvUNet`, `models/plainconvunet3d.py`, which the JAX package does
not have). `to_dict` leaves it out at its default, so that a MobileNet
run's `config.json` is the JAX package's.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from enum import Enum, auto
from typing import Optional, Tuple


MODEL_ARCHS = ("lraspp3d", "plainconvunet3d")


class DataParamMode(Enum):
    INSTANCE_PARAMS = auto()
    DISABLED = auto()


class LabelDisturbanceMode(Enum):
    FLIP_ROLL = auto()
    AFFINE = auto()


@dataclass
class TrainConfig:
    """Mirror of the reference `config_dict` (`main_deep_staple.py:75-137`)
    plus the JAX package's additions."""

    num_folds: int = 3
    only_first_fold: bool = True

    use_mind: bool = False
    epochs: int = 40

    batch_size: int = 8
    val_batch_size: int = 1
    use_2d_normal_to: Optional[str] = None

    num_val_images: int = 20
    atlas_count: int = 1

    dataset: str = "crossmoda"
    dataset_directory: str = "data/crossmoda_dataset"
    reg_state: Optional[str] = "acummulate_every_third_deeds_FT2_MT1"
    train_set_max_len: Optional[int] = None
    crop_3d_w_dim_range: Optional[Tuple[int, int]] = (45, 95)
    crop_2d_slices_gt_num_threshold: int = 0

    lr: float = 0.01
    use_scheduling: bool = True

    data_param_mode: DataParamMode = DataParamMode.INSTANCE_PARAMS
    init_inst_param: float = 0.0
    lr_inst_param: float = 0.1
    use_risk_regularization: bool = True
    use_fixed_weighting: bool = True
    use_ool_dp_loss: bool = True

    fixed_weight_file: Optional[str] = None
    fixed_weight_min_quantile: Optional[float] = None
    fixed_weight_min_value: Optional[float] = None
    override_embedding_weights: bool = False

    save_every: int = 200
    mdl_save_prefix: str = "data/models"

    debug: bool = False
    wandb_mode: str = "disabled"
    do_sweep: bool = False

    checkpoint_name: Optional[str] = None
    fold_override: Optional[int] = None
    checkpoint_epx: Optional[int] = None
    auto_resume: bool = False

    do_plot: bool = False
    save_dp_figures: bool = False
    save_labels: bool = True

    disturbance_mode: Optional[LabelDisturbanceMode] = None
    disturbance_strength: float = 0.0
    disturbed_percentage: float = 0.0

    device: str = "cuda"  # informational; entry points take an explicit device

    ool_mode: str = "strict"
    export_pth_snapshot: bool = False
    checkpoint_backend: str = "msgpack"
    compute_dtype: str = "float32"  # 'bfloat16' or anything else for float32
    augment_order: str = "reference"
    bn_mode: str = "batch"  # 'batch' | 'async' | 'slab'; eval is the same in all
    bn_warmup_epochs: int = 1
    use_checkpointing: bool = True
    model_arch: str = "lraspp3d"  # the port's: 'lraspp3d' | 'plainconvunet3d'
    mesh_data_axis: int = 1
    mesh_space_axis: int = 1
    mesh_model_axis: int = 1
    mesh_pipe_stages: int = 1
    pipe_microbatches: int = 1
    dist_num_processes: Optional[int] = None
    dist_coordinator: Optional[str] = None
    dist_process_id: Optional[int] = None
    seed: int = 0
    output_dir: str = "data/output"
    log_jsonl: bool = True
    profile_dir: Optional[str] = None
    profile_epoch: int = 1

    def __post_init__(self):
        if self.bn_mode not in ("batch", "async", "slab"):
            raise ValueError(
                f"bn_mode {self.bn_mode!r} (expected 'batch', 'async' or 'slab')"
            )
        if self.model_arch not in MODEL_ARCHS:
            raise ValueError(f"model_arch {self.model_arch!r} (expected one of {MODEL_ARCHS})")
        if self.model_arch == "plainconvunet3d":
            self._check_unet()
        if self.mesh_pipe_stages not in (1, 2):
            raise ValueError(
                f"mesh_pipe_stages {self.mesh_pipe_stages!r} (the model has "
                "exactly one natural stage cut — him+lom | aspp+head — so "
                "only 1 or 2 stages exist)"
            )
        if self.pipe_microbatches < 1:
            raise ValueError(f"pipe_microbatches {self.pipe_microbatches!r} < 1")
        if self.mesh_pipe_stages > 1:
            # The JAX package's checks (`deep_staple_tpu/core/config.py:218-242`).
            if (self.mesh_data_axis > 1 or self.mesh_space_axis > 1
                    or self.mesh_model_axis > 1):
                raise ValueError(
                    "mesh_pipe_stages > 1 is exclusive with the mesh_* axes "
                    "(pipeline stages are placed on explicit devices, not a "
                    "GSPMD mesh)"
                )
            if self.use_2d_normal_to is not None:
                raise ValueError(
                    "mesh_pipe_stages > 1 supports the 3D model only (the 2D "
                    "torchvision-style model has no him/lom|aspp/head cut)"
                )
            if self.batch_size % self.pipe_microbatches:
                raise ValueError(
                    f"batch_size {self.batch_size} not divisible by "
                    f"pipe_microbatches {self.pipe_microbatches}"
                )
            if (self.data_param_mode == DataParamMode.INSTANCE_PARAMS
                    and not self.use_ool_dp_loss):
                raise ValueError(
                    "mesh_pipe_stages > 1 requires the out-of-line DP "
                    "schedule (use_ool_dp_loss=True): the non-OOL DP loss "
                    "backprops its batch-coupled weight normalization into "
                    "the model, which does not decompose over microbatches"
                )

    def _check_unet(self):
        """The options `PlainConvUNet` cannot run with."""
        refused = [
            (self.bn_mode != "batch", f"bn_mode {self.bn_mode!r}: its InstanceNorm keeps no "
             "batch statistics (use bn_mode='batch')"),
            (self.use_checkpointing, "use_checkpointing: it has no remat segments"),
            (self.data_param_mode == DataParamMode.INSTANCE_PARAMS and not self.use_ool_dp_loss,
             "use_ool_dp_loss=False: its deep-supervision loss runs out of line only"),
            (self.use_2d_normal_to is not None, "use_2d_normal_to: it is a 3D network"),
            (self.mesh_data_axis > 1, "mesh_data_axis > 1: its data-parallel step is untested"),
            (self.mesh_model_axis > 1, "mesh_model_axis > 1: it has no tensor-parallel layout"),
            (self.mesh_space_axis > 1, "mesh_space_axis > 1: it has no spatial sharding"),
            (self.mesh_pipe_stages > 1, "mesh_pipe_stages > 1: it has no pipeline cut"),
            (self.checkpoint_backend == "orbax",
             "checkpoint_backend 'orbax': the JAX package has no such network"),
        ]
        for bad, why in refused:
            if bad:
                raise ValueError(f"model_arch 'plainconvunet3d' refuses {why}")

    def replace(self, **kw) -> "TrainConfig":
        return dataclasses.replace(self, **kw)

    @classmethod
    def tpu_production(cls, **kw) -> "TrainConfig":
        """The JAX package's production configuration
        (`deep_staple_tpu/core/config.py:247-305`), under the same name: fused
        out-of-line DP pass, 'fast-sep' augmentation, bfloat16, no remat,
        async BatchNorm after `bn_warmup_epochs` of slab BatchNorm. The
        dataclass defaults are the reference configuration."""
        base = dict(
            ool_mode="fused",
            augment_order="fast-sep",
            compute_dtype="bfloat16",
            use_checkpointing=False,
            bn_mode="async",
        )
        base.update(kw)
        return cls(**base)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        if d["model_arch"] == "lraspp3d":
            del d["model_arch"]
        for k, v in d.items():
            if isinstance(v, Enum):
                d[k] = str(v)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TrainConfig":
        fields = {f.name for f in dataclasses.fields(cls)}
        kw = {}
        for k, v in d.items():
            if k not in fields:
                continue
            if k == "data_param_mode" and isinstance(v, str):
                v = DataParamMode[v.split(".")[-1]]
            if k == "disturbance_mode" and isinstance(v, str):
                v = LabelDisturbanceMode[v.split(".")[-1]]
            if k == "crop_3d_w_dim_range" and v is not None:
                v = tuple(v)  # JSON stores the tuple as a list
            kw[k] = v
        return cls(**kw)


def _smart_value(s: str):
    """Parse a CLI string: ''/'none' -> None, 'a,b' -> tuple of ints,
    otherwise int -> float -> str."""
    if s is None or s.lower() in ("", "none", "null"):
        return None
    if "," in s:
        return tuple(int(p) for p in s.split(",") if p != "")
    for cast in (int, float):
        try:
            return cast(s)
        except ValueError:
            continue
    return s


def add_cli_args(parser, config: TrainConfig = TrainConfig()):
    """Register every config field as a CLI flag
    (`deep_staple_tpu/core/config.py:344-374`).

    Typed from each field's default: bools accept true/false, ints/floats are
    cast, None-able and tuple fields go through `_smart_value` (so
    `--crop-3d-w-dim-range 45,95` and `--crop-3d-w-dim-range none` both work).
    Every flag is registered under both spellings (`--batch-size` and
    `--batch_size`). `--device` (default "cuda") is how a caller asks for
    the CPU.
    """
    for f in dataclasses.fields(config):
        names = ["--" + f.name.replace("_", "-")]
        if "_" in f.name:
            names.append("--" + f.name)  # underscore alias, same dest
        default = getattr(config, f.name)
        if isinstance(default, bool):
            parser.add_argument(*names, type=lambda s: s.lower() in ("1", "true", "yes"), default=default)
        elif isinstance(default, Enum):
            parser.add_argument(*names, type=str, default=str(default))
        elif isinstance(default, int):
            parser.add_argument(*names, type=int, default=default)
        elif isinstance(default, float):
            parser.add_argument(*names, type=float, default=default)
        elif isinstance(default, str):
            parser.add_argument(*names, type=str, default=default)
        else:  # Optional[...] and tuples
            parser.add_argument(*names, type=_smart_value, default=default)
    return parser


def add_preset_arg(parser):
    """`--preset {reference,production}` for training-style CLIs."""
    parser.add_argument(
        "--preset", choices=("reference", "production"), default="reference",
        help="'reference' = reference-exact semantics (fp32, strict OOL, "
        "reference augment order, remat); 'production' = "
        "TrainConfig.tpu_production (fused OOL, fast-sep augment order, "
        "bfloat16, no remat, async BN). fast-sep packs binary labels only: on "
        "a non-binary dataset the driver picks fast-int8. Explicit flags "
        "override the preset either way.",
    )
    return parser


def apply_preset(overrides: dict, preset: str, argv_tokens) -> dict:
    """Merge a named preset into parsed CLI overrides, in place.

    Explicit flags always win over the preset: a field counts as explicit when
    its `--flag` token (either spelling, `--flag value` or `--flag=value`)
    appears in argv. Only fields the preset actually changes from the
    dataclass defaults are merged, so unrelated flags are never touched.
    """
    if preset == "production":
        explicit = {
            tok.split("=")[0].lstrip("-").replace("-", "_")
            for tok in argv_tokens
            if tok.startswith("--")
        }
        base = TrainConfig().to_dict()
        for k, v in TrainConfig.tpu_production().to_dict().items():
            if v != base[k] and k not in explicit:
                overrides[k] = v
    return overrides
