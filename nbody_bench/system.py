"""The system under test, built from a configuration file: a
``tpu_nbody_torch.engine.Engine`` with the configuration's ``SimConfig``
(the Barnes-Hut caps as the file fixes them), ``Params``, solver,
integrator and merge cap."""

from __future__ import annotations


def sim_config(config: dict):
    from tpu_nbody_torch.config import SimConfig

    kw = {k: tuple(v) if isinstance(v, list) else v
          for k, v in config["sim_config"].items()}
    return SimConfig(capacity=config["capacity"], world_w=config["world_w"],
                     world_h=config["world_h"], **kw)


def params(config: dict):
    from tpu_nbody_torch.config import Params

    p = config["params"]
    return Params.default(G=p["G"], dt=p["dt"], theta=p["theta"],
                          softening=p["softening"],
                          merge_max_mass=p["merge_max_mass"],
                          merge_min_dist=p["merge_min_dist"])


class Program:
    """The engine and the configuration's set-up around it."""

    def __init__(self, config: dict, device, workload=None):
        from tpu_nbody_torch.engine import Engine

        self.config = config
        self.cfg = sim_config(config)
        self.params = params(config)
        self.eng = Engine(self.cfg, self.params, solver=config["solver"],
                          integrator=config["integrator"],
                          merge_heavy_cap=config["merge_heavy_cap"],
                          device=device)

    def load(self, pos, vel, mass):
        self.eng.set_bodies(pos, vel, mass)

    def tuning(self):
        """What a retune changes: compared before and after each call (the
        engine grows a cap that overflows)."""
        return self.eng.caps, self.eng.merge_heavy_cap

    def counters(self) -> str:
        e = self.eng
        return (f"last_mesh_oob={e.last_mesh_oob} "
                f"last_rescue_need={e.last_rescue_need} "
                f"last_heavy_need={e.last_heavy_need} "
                f"merge_heavy_cap={e.merge_heavy_cap} caps={e.caps}"
                + (f" bh_needs={e.last_stats}" if e.last_stats else ""))
