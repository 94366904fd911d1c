"""Training and initial-state data (counterpart of ``climsim_tpu/data``):
the synthetic generator and the balanced equilibrium physics, the keeplev
H5 store and its TensorStore twin (``data.tsstore``), the chunk loaders,
the preprocessing chain, the normalizers, the native host loader
(``data.native``), and the data tools: the split file lists, raw-pair
ingestion and the npy export, the expanded features, the dataset
statistics and the Kaggle files."""
from .normalization import (Normalizer, LevelNormalizer, load_exp_lambdas,
                            save_norm_txt)
from .h5store import KeeplevWriter, KeeplevReader, concatenate, \
    write_timeseries
from .loader import (chunkize, keeplev_chunks, stream_keeplev_chunks,
                     prefetch_to_device, flat_batches)
from .synthetic import (EquilibriumConfig, SyntheticConfig,
                        equilibrium_emulator, equilibrium_forcing,
                        equilibrium_physics, generate_state)
from .filelist import FileLists, official_split_regexps
from .expand import derive_tendencies, expand_features, location_features
# ingest() itself stays under data.ingest: its name is the module's
from .ingest import keeplev_to_flat, pack_pair, save_as_npy
from .statistics import dataset_statistics, level_statistics, \
    save_statistics
from .kaggle import export_kaggle_files, kaggle_index_lists
from .tsstore import TsKeeplevStore

__all__ = ["Normalizer", "LevelNormalizer", "load_exp_lambdas",
           "save_norm_txt", "KeeplevWriter", "KeeplevReader", "concatenate",
           "write_timeseries", "chunkize",
           "keeplev_chunks", "stream_keeplev_chunks", "prefetch_to_device",
           "flat_batches", "SyntheticConfig", "generate_state",
           "EquilibriumConfig", "equilibrium_forcing", "equilibrium_physics",
           "equilibrium_emulator", "FileLists", "official_split_regexps",
           "derive_tendencies", "expand_features", "location_features",
           "keeplev_to_flat", "pack_pair", "save_as_npy",
           "dataset_statistics", "level_statistics", "save_statistics",
           "export_kaggle_files", "kaggle_index_lists", "TsKeeplevStore"]
