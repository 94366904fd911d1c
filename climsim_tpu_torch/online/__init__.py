from .advection import (build_proxy_grid, to_grid, to_columns,
                        fv_advect_2d, fv_advect_2d_sphere,
                        semi_lagrangian_2d, semi_lagrangian_2d_halo,
                        semi_lagrangian_halo_clip_fraction,
                        vertical_advect_column,
                        diagnose_omega, conservation_fixer, SphericalMetric,
                        spherical_metric)
from .host_loop import HybridLoop, HostLoopConfig, sharded_hybrid_step

__all__ = ["build_proxy_grid", "to_grid", "to_columns", "fv_advect_2d",
           "fv_advect_2d_sphere", "semi_lagrangian_2d",
           "semi_lagrangian_2d_halo", "semi_lagrangian_halo_clip_fraction",
           "vertical_advect_column", "diagnose_omega", "conservation_fixer",
           "SphericalMetric", "spherical_metric", "HybridLoop",
           "HostLoopConfig", "sharded_hybrid_step"]
