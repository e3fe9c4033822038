"""The model configuration as the reference reads it: the `model` fields
of a configuration file, with the derived values of the program's
`VDETRConfig` (frozen copy of `vdetr_tpu_torch/config.py`)."""

from __future__ import annotations

from types import SimpleNamespace


class RefConfig(SimpleNamespace):
    @property
    def focal_alpha(self) -> float:
        parts = self.cls_loss.split("_")
        return float(parts[1]) if len(parts) > 1 else 0.25

    @property
    def use_focal(self) -> bool:
        return self.cls_loss.split("_")[0] == "focalloss"

    @property
    def backbone_in_dim(self) -> int:
        d = 3
        if self.use_color and self.xyz_color:
            d = 6
        if self.use_normals:
            d += 3
        return d

    @property
    def rpe_table_points(self) -> int:
        return int(self.rpe_quant.split("_")[2])

    def stage_capacities(self):
        caps = [self.voxel_capacity]
        for _ in range(self.num_stages + 1):
            caps.append(max(caps[-1] // self.stage_capacity_divisor,
                            self.min_stage_capacity))
        return tuple(caps)


def ref_config(conf: dict) -> RefConfig:
    """The reference's config of a configuration file: its `model` fields
    and its dataset's class and angle-bin counts."""
    fields = dict(conf["model"])
    fields["num_semcls"] = conf["dataset_config"]["num_semcls"]
    fields["num_angle_bin"] = conf["dataset_config"]["num_angle_bin"]
    for k in ("grid_extent", "mesh_shape", "mesh_axis_names"):
        fields[k] = tuple(fields[k])
    return RefConfig(**fields)
