"""Training and initial-state data (counterpart of ``climsim_tpu/data``):
the synthetic generator and the balanced equilibrium physics, the keeplev
H5 store, the chunk loaders, the preprocessing chain, the normalizers and
the native host loader (``data.native``)."""
from .normalization import (Normalizer, LevelNormalizer, load_exp_lambdas,
                            save_norm_txt)
from .h5store import KeeplevWriter, KeeplevReader, concatenate, \
    write_timeseries
from .loader import (chunkize, keeplev_chunks, stream_keeplev_chunks,
                     prefetch_to_device, flat_batches)
from .synthetic import (EquilibriumConfig, SyntheticConfig,
                        equilibrium_emulator, equilibrium_forcing,
                        equilibrium_physics, generate_state)

__all__ = ["Normalizer", "LevelNormalizer", "load_exp_lambdas",
           "save_norm_txt", "KeeplevWriter", "KeeplevReader", "concatenate",
           "write_timeseries", "chunkize",
           "keeplev_chunks", "stream_keeplev_chunks", "prefetch_to_device",
           "flat_batches", "SyntheticConfig", "generate_state",
           "EquilibriumConfig", "equilibrium_forcing", "equilibrium_physics",
           "equilibrium_emulator"]
