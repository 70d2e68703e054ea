"""Static configuration and dynamic parameters (port of tpu_nbody.config).

* :class:`SimConfig` — frozen facts about a run: capacity, world extent,
  the Barnes–Hut knobs and the P3M knobs. Only the fields the port runs
  are carried: the JAX package's ``bh_allow_twin_traversal`` and
  ``bh_stream_split`` work around one TPU backend and have no counterpart.
* :class:`Params` — the live-tunable physics scalars. The JAX package keeps
  them as a pytree of f32 arrays so a jitted step can take new values
  without recompiling; PyTorch runs eagerly, so here they are Python floats,
  each rounded to float32 so that every op sees the same value the JAX
  package's f32 arrays hold.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

# Reference defaults (src/main/kotlin/Config.kt:5-38).
WIDTH_PX = 2400.0
HEIGHT_PX = 800.0
G_DEFAULT = 80.0
DT_DEFAULT = 0.005
SOFTENING_DEFAULT = 1.0
THETA_DEFAULT = 0.30
DISK_R_DEFAULT = 100.0
DISK_N_DEFAULT = 5_000
CENTRAL_MASS = 50_000.0
MIN_R = 8.0
TOTAL_SATELLITE_MASS = 5_000.0
# Merge rule defaults (src/main/kotlin/BarnesHutAlg.kt:315-321).
MERGE_MAX_MASS_DEFAULT = 4_000.0

# GPU demo defaults (src/main/kotlin/gpu/GPU.kt:15-75).
GPU_WIDTH_PX = 3440.0
GPU_HEIGHT_PX = 1440.0
GPU_CENTRAL_MASS = 5_000.0
GPU_MIN_R = 2.0
GPU_TOTAL_SATELLITE_MASS = 25_000.0


def f32(x) -> float:
    """``x`` rounded to the nearest float32, as a Python float."""
    return float(np.float32(x))


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static simulation configuration (tpu_nbody's, less its two
    TPU-backend workarounds).

    ``capacity`` is the fixed body-slot count; the live count is the
    ``alive`` mask of :class:`tpu_nbody_torch.state.SimState`. Field
    meanings and defaults are those of ``tpu_nbody.config.SimConfig``.
    """

    capacity: int
    world_w: float = WIDTH_PX
    world_h: float = HEIGHT_PX
    dim: int = 2
    # Adaptive quadtree knobs (BH solver).
    leaf_size: int = 16            # max bodies per leaf before splitting
    max_depth: int = 14            # max tree levels below root (<= 15)
    node_capacity: int = 0         # 0 -> auto (from capacity / leaf_size)
    group_size: int = 512          # max bodies per traversal group (tree node)
    group_cap: int = 0             # 0 -> auto: padded group-slot count
    # Traversal list caps (padded shapes; the engine regrows them on overflow).
    approx_cap: int = 4096         # max accepted multipole nodes per group
    leaf_list_cap: int = 512       # max opened leaves per group
    direct_body_cap: int = 4096    # max direct (body-body) partners per group
    frontier_cap: int = 2048       # max BFS frontier nodes per wave per group
    group_chunk: int = 64          # groups per force-evaluation chunk (upper
                                   # bound; a byte budget may lower it)
    bh_traversal: str = "auto"     # "dense" = local monotone-MAC classify,
                                   # "bfs" = wave traversal (cross-check),
                                   # "hier" = chunk-hierarchical candidates +
                                   # masked-dense evaluation (large N),
                                   # "auto" = dense up to BH_DENSE_MAX_CAP
                                   # capacity, hier above
    bh_hier_sizes: tuple = (1024, 64, 8)   # hier: groups per chunk at each
                                   # refinement level (descending, each
                                   # divides the previous; levels >= the
                                   # group count are skipped)
    bh_hier_cand_caps: tuple = (131072, 32768, 4096)  # hier: per-chunk
                                   # candidate-list cap per level (regrown on
                                   # overflow; clipped to the node table)
    bh_hier_batch: int = 32        # hier: chunks per batch of the needs
                                   # (and of the CPU's masked-dense sums)
    # P3M ("pm") solver knobs.
    mesh_level: int = 11           # world grid = 2^level per side over the root
    mesh_split: float = 4.0        # short/long split radius in cell units
    mesh_band: int = 256           # sorted-order block size for F_short
    mesh_chunk: int = 16384        # bodies per band/rescue chunk (memory bound)
    mesh_order: int = 2            # mass assignment: 1 NGP, 2 CIC, 3 TSC
    mesh_switch: str = "exp4"      # short/long switch: "exp4" or "poly4"
    mesh_deconvolve: bool = True   # bake the 1/What^2 sharpening into the hats
    mesh_interlace: bool = False   # average a half-cell-shifted second mesh
    mesh_ny: int = 0               # rectangular mesh rows (0 = square)
    mesh_rescue: int = 4           # rescue partner blocks per band block
    mesh_rescue_hot: int = 0       # two-tier rescue: partner blocks of a hot
                                   # block (need > mesh_rescue); 0 = one tier
    mesh_rescue_hot_cap: int = 128  # most hot blocks a pass serves
    mesh_xrescue: int = 4          # sharded pm only: cross-shard rescue
                                   # partner blocks per block (0 = off)
    mesh_xrescue_export: int = 64  # sharded pm only: boundary blocks a
                                   # shard exports for that rescue
    pm_persistent_sort: bool = True  # pm + kdk_reuse: sorted-carry step
    pm_resort_every: int = 8       # steps between re-sorts
    pm_mesh_every: int = 1         # F_long subcycling: steps between mesh
                                   # refreshes (> 1 needs pm_heavy_cap > 0)
    pm_heavy_cap: int = 0          # heaviest bodies kept off the mesh, their
                                   # F_long summed directly every step
    pm_self_correct: bool = True   # cancel the stale-grid self-term
    pm_mesh_extrapolate: bool = False  # subcycling: extrapolate T + age/M·ΔT
    dtype: str = "float32"

    @property
    def tdtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def root_half(self) -> float:
        """Root quad half-side: max(W, H)/2 + 2, centred at (W/2, H/2)
        (``src/main/kotlin/BarnesHutAlg.kt:359-362``)."""
        return max(self.world_w, self.world_h) / 2.0 + 2.0

    @property
    def root_center(self) -> tuple[float, float]:
        return (self.world_w / 2.0, self.world_h / 2.0)

    @property
    def num_nodes(self) -> int:
        """Node-table slots: ``node_capacity``, or 8 per leaf_size bodies
        (a split spawns up to 4 children; generous headroom) plus 64."""
        if self.node_capacity:
            return self.node_capacity
        return 8 * max(self.capacity // self.leaf_size, 1) + 64

    @property
    def num_groups(self) -> int:
        if self.group_cap:
            return self.group_cap
        return 8 * max(self.capacity // self.group_size, 1) + 64


@dataclasses.dataclass(frozen=True)
class Params:
    """Physics scalars: G, dt, theta, soft2 = softening², merge_max_mass,
    merge_min_dist (``merge_min_dist <= 0`` disables merging). Field order
    is the JAX package's, which its checkpoint format relies on."""

    G: float
    dt: float
    theta: float
    soft2: float
    merge_max_mass: float
    merge_min_dist: float

    def __post_init__(self):
        for f in dataclasses.fields(self):
            object.__setattr__(self, f.name, f32(getattr(self, f.name)))

    @classmethod
    def default(
        cls,
        G: float = G_DEFAULT,
        dt: float = DT_DEFAULT,
        theta: float = THETA_DEFAULT,
        softening: float = SOFTENING_DEFAULT,
        merge_max_mass: float = MERGE_MAX_MASS_DEFAULT,
        merge_min_dist: float = MIN_R,
    ) -> "Params":
        return cls(G=G, dt=dt, theta=theta, soft2=softening * softening,
                   merge_max_mass=merge_max_mass,
                   merge_min_dist=merge_min_dist)

    def replace(self, **kw) -> "Params":
        return dataclasses.replace(self, **kw)
