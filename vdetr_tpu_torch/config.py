"""The model configuration of the port: a copy of the JAX package's
`VDETRConfig` (`vdetr_tpu/config.py`), so that the port imports nothing
of that package.

The fields, defaults, properties, `stage_capacities`, `replace` and
`validate` are the JAX package's; `tests/test_torch_train_config.py`
holds the two equal. Defaults are the published ScanNet recipe
(reference README.md:98-107). Some fields name TPU machinery
(`rpe_impl`, `fps_impl`, `mesh_*`); the port reads none of them, and
keeps them so that a configuration means the same in both packages.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class VDETRConfig:
    # ---- Optimizer (reference main.py:33-43) ----
    base_lr: float = 7e-4
    warm_lr: float = 1e-6
    warm_lr_epochs: int = 9
    final_lr: float = 1e-6
    lr_scheduler: str = "cosine"  # "cosine" | "step"
    weight_decay: float = 0.1
    filter_biases_wd: bool = False
    clip_gradient: float = 0.1

    # ---- Model (reference main.py:45-64) ----
    model_name: str = "vdetr"
    num_points: int = 100000
    minkowski: bool = True          # sparse-conv backbone (always true here)
    mink_syncbn: bool = True        # sync BN stats over the data mesh axis
    stem_bn: bool = True            # BatchNorm (vs InstanceNorm) in the stem
    voxel_size: float = 0.01
    depth: int = 34                 # ResNet depth: 18|34 (BasicBlock), 50|101|152 (Bottleneck)
    inplanes: int = 64
    num_stages: int = 4
    use_fpn: bool = True
    layer_idx: int = 0              # FPN output stage index
    enc_dim: int = 256

    # ---- Decoder (reference main.py:71-89) ----
    dec_nlayers: int = 9            # 1 FFN "first layer" + 8 full layers
    dec_dim: int = 256
    dec_ffn_dim: int = 256
    dec_dropout: float = 0.1
    dec_nhead: int = 4
    rpe_dim: int = 128
    rpe_quant: str = "bilinear_4_10"  # interp method, max_value, table points
    log_scale: float = 512.0
    pos_for_key: bool = False
    querypos_mlp: bool = True
    q_content: str = "random"       # "sample"|"zero"|"random"|"random_add"
    repeat_num: int = 5             # GT repetition factor (0/1 = off)
    proj_nohid: bool = True
    woexpand_conv: bool = True      # plain (not generative) transpose conv
    share_selfattn: bool = False

    # ---- MLP heads (reference main.py:91-101) ----
    mlp_dropout: float = 0.3
    mlp_norm: str = "bn1d"
    mlp_act: str = "relu"
    mlp_sep: bool = True
    nsemcls: int = -1

    # ---- Other model params (reference main.py:103-113) ----
    preenc_npoints: int = 4096
    nqueries: int = 1024
    is_bilable: bool = True
    no_first_repeat: bool = True
    axis_align_test: bool = False
    iou_type: str = "giou"          # "giou" | "diou" | "iou"
    angle_type: str = ""            # "" | "world_coords" | "object_coords"
    use_normals: bool = False
    hard_anchor: bool = False
    random_fps: bool = False        # reference reads this flag but never
                                    # defines it (model_vdetr.py:87, latent bug)

    # ---- Matcher costs (reference main.py:117-124) ----
    matcher_giou_cost: float = 2.0
    matcher_cls_cost: float = 3.0
    matcher_center_cost: float = 1.0
    matcher_objectness_cost: float = 0.0
    matcher_size_cost: float = 0.5
    matcher_anglecls_cost: float = 0.0
    matcher_anglereg_cost: float = 0.0

    # ---- Loss weights (reference main.py:126-137) ----
    cls_loss: str = "focalloss_0.25"
    loss_giou_weight: float = 2.0
    loss_sem_cls_weight: float = 3.0
    loss_no_object_weight: float = 0.0
    loss_angle_cls_weight: float = 0.1
    loss_angle_reg_weight: float = 0.5
    loss_center_weight: float = 1.0
    loss_size_weight: float = 0.5
    point_cls_loss_weight: float = 0.05

    # ---- Dataset (reference main.py:139-173) ----
    dataset_name: str = "scannet"   # "scannet" | "sunrgbd" | "synthetic"
    dataset_root_dir: Optional[str] = None
    meta_data_dir: Optional[str] = None
    dataset_num_workers: int = 8
    batchsize_per_gpu: int = 1      # per-device batch
    filt_empty: bool = True
    rot_ratio: float = 5.0
    trans_ratio: float = 0.4
    scale_ratio: float = 0.4
    use_color: bool = False
    xyz_color: bool = False
    color_drop: float = 0.0
    color_contrastp: float = 0.0
    color_jitterp: float = 0.0
    hue_sat: str = "0.5_0.2_0.0"
    color_mean: float = -1.0
    coloraug_sunrgbd: bool = False

    # ---- Training (reference main.py:175-180) ----
    start_epoch: int = -1
    max_epoch: int = 540
    step_epoch: str = ""
    eval_every_epoch: int = 10
    seed: int = 0

    # ---- Testing / NMS (reference main.py:182-198) ----
    test_only: bool = False
    auto_test: bool = False
    test_no_nms: bool = False
    no_3d_nms: bool = False
    rotated_nms: bool = False
    nms_iou: float = 0.25
    empty_pt_thre: int = 5
    conf_thresh: float = 0.0
    test_ckpt: Optional[str] = None
    angle_nms: bool = False
    angle_conf: bool = False
    use_old_type_nms: bool = False
    no_cls_nms: bool = False
    no_per_class_proposal: bool = False
    use_cls_confidence_only: bool = False
    test_size: bool = False
    tta: bool = False               # flip-ensemble test-time augmentation
                                    # (reference README.md:93 claims it but
                                    # never shipped the code; see eval/tta.py)

    # ---- wandb (reference main.py:210-214; optional, zero-egress safe) ----
    wandb_activate: bool = False
    wandb_entity: Optional[str] = None
    wandb_project: str = "vdetr"
    wandb_key: str = ""

    # ---- I/O (reference main.py:200-204) ----
    checkpoint_dir: Optional[str] = None
    log_every: int = 10
    log_metrics_every: int = 20
    save_separate_checkpoint_every_epoch: int = 1

    # ---- TPU-native additions (no reference counterpart) ----
    # Static capacities of the padded buffers. The reference uses dynamic
    # shapes per scene; on TPU every shape is compile-time static and
    # overflow beyond capacity is dropped (validity-masked).
    max_num_obj: int = 64             # GT slots (datasets/scannet.py:467)
    voxel_capacity: int = 131072      # voxels at the raw 1cm level
    stage_capacity_divisor: int = 2   # per-downsample capacity shrink factor
    min_stage_capacity: int = 2048
    grid_extent: Tuple[int, int, int] = (2048, 2048, 512)  # int32-packable
    fps_impl: str = "auto"            # "auto" | "pallas" | "jax"
    rpe_impl: str = "fused"           # "fused": Pallas flash kernel with
                                      # gather-free in-VMEM trilinear bias
                                      # (24 ms/layer on v5e) for
                                      # dropout-free passes; training and
                                      # non-TPU backends use the
                                      # "materialized" XLA bias scan
                                      # (trilinear_sample_matmul).
                                      # HBM note: the fused-path backward
                                      # materializes two
                                      # (B, H*nQ, nK) f32 tensors (ds/eg,
                                      # ops/rpe_attention.py:_bwd_kernel_a)
                                      # = 2*B*8*1024*nK*4 bytes per layer
                                      # backward — ~128 MB at B=1/nK=2048,
                                      # linear in B and nK; budget for it
                                      # before raising either at train
                                      # time.
                                      # "materialized" forces the scan
                                      # everywhere.
                                      # HBM note: the fused training
                                      # backward stages two
                                      # (B, H, nQ, nK) f32 tensors in
                                      # HBM (~128 MB at B=1 published
                                      # size, linear in B and nK);
                                      # budget ~8*B*H*nQ*nK bytes when
                                      # raising batch or key count.
    matcher_impl: str = "auction"     # "auction" (eps-optimal, fast on TPU)
                                      # | "jv" (exact Jonker-Volgenant)
    compute_dtype: str = "float32"    # "float32" | "bfloat16" matmul dtype
    mesh_shape: Tuple[int, ...] = (-1,)  # -1 = all devices on 'data'
    mesh_axis_names: Tuple[str, ...] = ("data",)
    profile_dir: Optional[str] = None

    # ---- derived helpers ----
    @property
    def seq_axis(self) -> Optional[str]:
        """Key/point-sharding mesh axis (BASELINE "large-scene stress"
        config): present when the mesh declares a "seq" axis. Points are
        sharded across it; decoder queries stay replicated and the
        cross-attention combines per-shard logits with one psum/pmax
        (parallel/seq_attention.py). The reference has nothing comparable
        (SURVEY.md §2.3)."""
        return "seq" if "seq" in self.mesh_axis_names else None

    @property
    def focal_alpha(self) -> float:
        parts = self.cls_loss.split("_")
        return float(parts[1]) if len(parts) > 1 else 0.25

    @property
    def use_focal(self) -> bool:
        return self.cls_loss.split("_")[0] == "focalloss"

    @property
    def rpe_interp(self) -> str:
        return self.rpe_quant.split("_")[0]

    @property
    def rpe_max_value(self) -> float:
        return float(self.rpe_quant.split("_")[1])

    @property
    def rpe_table_size(self) -> int:
        return int(self.rpe_quant.split("_")[2])

    @property
    def point_dim(self) -> int:
        d = 3
        if self.use_color and self.xyz_color:
            d = 6
        if self.use_normals:
            d += 3
        return d

    @property
    def backbone_in_dim(self) -> int:
        """Channels fed to the sparse backbone (reference model_vdetr.py:393-403)."""
        return self.point_dim

    def stage_capacities(self) -> Tuple[int, ...]:
        """Static voxel capacity for [raw, stem, stage1..num_stages]."""
        caps = [self.voxel_capacity]
        for _ in range(self.num_stages + 1):  # stem + stages
            caps.append(max(caps[-1] // self.stage_capacity_divisor,
                            self.min_stage_capacity))
        return tuple(caps)

    def replace(self, **kw) -> "VDETRConfig":
        return dataclasses.replace(self, **kw)

    def validate(self) -> "VDETRConfig":
        """Reject non-default values of fields that cannot take effect.

        A config that silently ignores a flag is worse than one that
        refuses it. The fields below are dead or broken in the reference
        itself, so no behavior exists to reproduce:
        - nsemcls: parsed but never read (reference main.py:97 only);
        - no_first_repeat: parsed but never read anywhere;
        - mlp_sep=False: reference indexes self.mlp_heads[idx] with an int,
          which a ModuleDict rejects (vdetr_transformer.py:225-234, 261) —
          the shared-heads path crashes there;
        - minkowski=False: no non-sparse backbone is reachable.
        """
        if self.nsemcls != -1:
            raise ValueError(
                "nsemcls is dead in the reference (parsed, never read); "
                "the class count always comes from the dataset config"
            )
        if not self.no_first_repeat:
            raise ValueError(
                "no_first_repeat is dead in the reference (parsed, never "
                "read); only the default True is supported"
            )
        if not self.mlp_sep:
            raise ValueError(
                "mlp_sep=False is broken in the reference (ModuleDict "
                "indexed by int, vdetr_transformer.py:261); only separate "
                "per-layer heads are supported"
            )
        if not self.minkowski:
            raise NotImplementedError(
                "minkowski=False (non-sparse backbone) is not implemented; "
                "the sparse voxel backbone is the only shipped path"
            )
        if self.rpe_impl not in ("fused", "materialized"):
            raise ValueError(f"unknown rpe_impl {self.rpe_impl!r}")
        if self.compute_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown compute_dtype {self.compute_dtype!r}")
        if self.matcher_impl not in ("auction", "jv"):
            raise ValueError(f"unknown matcher_impl {self.matcher_impl!r}")
        if self.fps_impl not in ("auto", "pallas", "jax"):
            raise ValueError(f"unknown fps_impl {self.fps_impl!r}")
        return self


# Keys restored from the CLI (not the checkpoint) under --auto_test
# (reference main.py:218-233).
AUTO_TEST_IGNORE_KEYS = [
    "test_only", "auto_test", "test_no_nms", "no_3d_nms", "rotated_nms",
    "tta",
    "nms_iou", "empty_pt_thre", "conf_thresh", "test_ckpt", "angle_nms",
    "angle_conf", "use_old_type_nms", "no_cls_nms", "filt_empty",
    "no_per_class_proposal", "use_cls_confidence_only", "test_size",
    "model_name", "dataset_root_dir", "meta_data_dir", "checkpoint_dir",
]
