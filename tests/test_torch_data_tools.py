"""The port's data tools (``climsim_tpu_torch/data/{filelist,expand,
statistics,kaggle,ingest,tsstore}.py``) against the JAX package's on the
CPU, on the same files and numpy inputs made from a seed: the file lists,
the statistics and their JSON and the Kaggle text files equal byte for
byte; the expanded features and the ingested pairs within 1e-6 (relative
to each array's scale); the keeplev H5, the npy/h5/pickle export and the
TensorStore store equal. The raw file pairs and the grid file are classic
netCDF written here by ``scipy.io.netcdf_file``. JAX runs with the
suite's x64 on, under which its ingestion computes the mid-level pressure
and the relative humidity in float64."""
import filecmp
import os
import pickle

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import netcdf_file

from climsim_tpu import variables as JV
from climsim_tpu.data import LevelNormalizer as JLevelNormalizer
from climsim_tpu.data import Normalizer as JNormalizer
from climsim_tpu.data import expand as jexpand
from climsim_tpu.data import filelist as jfilelist
from climsim_tpu.data import ingest as jingest
from climsim_tpu.data import kaggle as jkaggle
from climsim_tpu.data import statistics as jstatistics
from climsim_tpu.data.h5store import KeeplevReader as JKeeplevReader
from climsim_tpu.grid import Grid as JGrid
from climsim_tpu_torch import Grid
from climsim_tpu_torch import variables as V
from climsim_tpu_torch.data import (LevelNormalizer, Normalizer, expand,
                                    filelist, ingest, kaggle, statistics)
from climsim_tpu_torch.data.h5store import KeeplevReader

NCOL, NLEV = 48, 60


def close(got, want, rtol=1e-6, err_msg=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, err_msg
    assert got.dtype == want.dtype, err_msg
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-30),
                               err_msg=err_msg)


# ------------------------------------------------------------ file lists


def test_filelists_equal(tmp_path):
    stamps = [f"000{y}-{m:02d}-{d:02d}-{s:05d}" for y in (1, 2, 8, 9)
              for m in (1, 2, 7) for d in (1, 15) for s in (0, 1200)]
    for st in stamps:
        sub = tmp_path / st[:7]
        sub.mkdir(exist_ok=True)
        for ab in ("mli", "mlo"):
            (sub / f"E3SM-MMF.{ab}.{st}.nc").touch()
    for years in ((1, 8), (1, 3)):
        jfl = jfilelist.FileLists(str(tmp_path))
        fl = filelist.FileLists(str(tmp_path))
        rx = filelist.official_split_regexps(years)
        assert rx == jfilelist.official_split_regexps(years)
        for split, r in rx.items():
            jfl.set_regexps(split, r)
            fl.set_regexps(split, r)
        fl.set_stride_sample("val", 3)
        jfl.set_stride_sample("val", 3)
        for split in rx:
            got = fl.get_filelist(split)
            assert got == jfl.get_filelist(split) and got, split
            assert [fl.output_path(f) for f in got] \
                == [jfl.output_path(f) for f in got]
            assert all(".mlo." in fl.output_path(f) for f in got)
    assert filelist.DEFAULT_STRIDES == jfilelist.DEFAULT_STRIDES
    with pytest.raises(AssertionError):
        fl.set_regexps("holdout", ["*"])


# ------------------------------------------------------------ expand


def test_expand_features_equal():
    rng = np.random.default_rng(0)
    names = ("state_t", "state_q0001", "state_q0002", "state_q0003",
             "state_u")
    scale = {"state_t": 250.0, "state_q0001": 1e-3, "state_q0002": 1e-5,
             "state_q0003": 1e-5, "state_u": 10.0}
    shape = (5, 12, NLEV)
    mli = {n: (scale[n] * (1 + 0.1 * rng.normal(size=shape)))
           .astype(np.float32) for n in names}
    mlo = {n: (mli[n] * (1 + 1e-3 * rng.normal(size=shape)))
           .astype(np.float32) for n in names}
    want = jexpand.expand_features(
        {k: jnp.asarray(v) for k, v in mli.items()},
        {k: jnp.asarray(v) for k, v in mlo.items()})
    got = expand.expand_features(
        {k: torch.as_tensor(v) for k, v in mli.items()},
        {k: torch.as_tensor(v) for k, v in mlo.items()})
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    # the history repeats the first step; it is not zero-padded
    np.testing.assert_array_equal(got["tm_state_t"][0].numpy(),
                                  mli["state_t"][0])
    tend = expand.derive_tendencies(torch.as_tensor(mli["state_t"]),
                                    torch.as_tensor(mlo["state_t"]))
    np.testing.assert_array_equal(tend.numpy(), np.asarray(
        jexpand.derive_tendencies(jnp.asarray(mli["state_t"]),
                                  jnp.asarray(mlo["state_t"]))))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_location_features_equal(dtype):
    lat = np.linspace(-89.5, 89.5, 37).astype(dtype)
    lon = np.linspace(0, 350, 37).astype(dtype)
    want = jexpand.location_features(jnp.asarray(lat), jnp.asarray(lon))
    got = expand.location_features(torch.as_tensor(lat),
                                   torch.as_tensor(lon))
    assert list(got) == list(want)
    for k in want:
        close(got[k].numpy(), np.asarray(want[k]), 1e-6, k)
    np.testing.assert_array_equal(got["icol"].numpy(), np.arange(1, 38))


# ------------------------------------------------------------ statistics


def test_statistics_equal(tmp_path):
    rng = np.random.default_rng(1)
    x = rng.normal(2.0, 3.0, (300, 124)).astype(np.float32)
    x[:, 5] = 1.5                      # a constant level: lo == hi
    lv = statistics.level_statistics(x[:, :60], nbins=16)
    jlv = jstatistics.level_statistics(x[:, :60], nbins=16)
    for k in ("mean", "std", "min", "max", "hist", "bin_edges"):
        np.testing.assert_array_equal(lv[k], jlv[k], err_msg=k)
    for p in statistics.PCTS:
        np.testing.assert_array_equal(lv["pct"][str(p)], jlv["pct"][str(p)])
    y = rng.normal(0, 1, (300, 128)).astype(np.float32)
    for which, data in (("inputs", x), ("outputs", y)):
        st = statistics.dataset_statistics(data, "v1", which, nbins=20)
        jst = jstatistics.dataset_statistics(data, "v1", which, nbins=20)
        assert list(st) == list(jst)
        statistics.save_statistics(st, str(tmp_path / f"{which}.json"))
        jstatistics.save_statistics(jst, str(tmp_path / f"j{which}.json"))
        assert filecmp.cmp(tmp_path / f"{which}.json",
                           tmp_path / f"j{which}.json", shallow=False)


# ------------------------------------------------------------ kaggle


@pytest.mark.parametrize("vset", ["v2", "v1", "v4"])
def test_kaggle_index_lists_equal(vset):
    for got, want in zip(kaggle.kaggle_index_lists(vset),
                         jkaggle.kaggle_index_lists(vset)):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype


def test_kaggle_files_equal(tmp_path):
    vs = V.get("v2")
    rng = np.random.default_rng(2)
    mean = rng.normal(0, 100, vs.input_feature_len)
    maxv = mean + rng.uniform(1, 50, vs.input_feature_len)
    minv = mean - rng.uniform(1, 50, vs.input_feature_len)
    scale = 10.0 ** rng.uniform(-3, 8, vs.target_feature_len)
    nz = Normalizer.from_arrays(mean, maxv, minv, scale)
    jnz = JNormalizer.from_arrays(mean, maxv, minv, scale)
    info = kaggle.export_kaggle_files(nz, str(tmp_path / "t"), "v2")
    assert info == jkaggle.export_kaggle_files(jnz, str(tmp_path / "j"),
                                               "v2")
    names = sorted(os.listdir(tmp_path / "j"))
    assert names == sorted(os.listdir(tmp_path / "t")) and len(names) == 5
    for f in names:
        assert filecmp.cmp(tmp_path / "t" / f, tmp_path / "j" / f,
                           shallow=False), f


# ------------------------------------------------------------ ingest

CAM_OUT = ("cam_out_NETSW", "cam_out_FLWDS", "cam_out_PRECSC",
           "cam_out_PRECC", "cam_out_SOLS", "cam_out_SOLL", "cam_out_SOLSD",
           "cam_out_SOLLD")
DERIVED = {"state_rh", "state_qn", "liq_partition", "icol", "clat", "slat",
           "state_qn_prvphy", "tm_state_qn_prvphy"}


def write_grid(path):
    """A classic netCDF grid file of NCOL columns: Grid.synthetic's
    arrays (lat, lon, area, hyai, hybi, hyam, hybm) and P0."""
    g = Grid.synthetic(NCOL, NLEV, dtype=torch.float64)
    with netcdf_file(path, "w") as f:
        for d, n in (("ncol", NCOL), ("lev", NLEV), ("ilev", NLEV + 1)):
            f.createDimension(d, n)
        for k, d in (("lat", "ncol"), ("lon", "ncol"), ("area", "ncol"),
                     ("hyai", "ilev"), ("hybi", "ilev"), ("hyam", "lev"),
                     ("hybm", "lev")):
            f.createVariable(k, "d", (d,))[:] = getattr(g, k).numpy()
        f.createVariable("P0", "d", ())[...] = 1.0e5
    return str(path)


def raw_fields(vset_name, seed):
    """The raw mli/mlo fields of one step for a variable set: the state,
    the surface fluxes and every input not derived by ingestion."""
    rng = np.random.default_rng(seed)
    lev = lambda lo, hi: rng.uniform(lo, hi, (NCOL, NLEV))
    base = {"state_t": lev(200, 300),
            "state_q0001": np.abs(rng.normal(1e-3, 3e-4, (NCOL, NLEV))),
            "state_q0002": np.abs(rng.normal(1e-5, 3e-6, (NCOL, NLEV))),
            "state_q0003": np.abs(rng.normal(1e-5, 3e-6, (NCOL, NLEV))),
            "state_u": rng.normal(0, 10, (NCOL, NLEV)),
            "state_v": rng.normal(0, 3, (NCOL, NLEV)),
            "state_ps": rng.uniform(9.6e4, 1.03e5, NCOL)}
    vs = V.get(vset_name)
    need = set(vs.inputs.names) - DERIVED
    if "state_qn_prvphy" in vs.inputs.names:
        need |= {"state_q0002_prvphy", "state_q0003_prvphy",
                 "tm_state_q0002_prvphy", "tm_state_q0003_prvphy"}
    mli = dict(base)
    for n in sorted(need - set(mli)):
        shape = (NCOL, NLEV) if V.var_len(n) == NLEV else (NCOL,)
        mli[n] = np.abs(rng.normal(0.5, 0.2, shape))
    mlo = {k: v + rng.normal(0, 1e-3 * (np.abs(v).mean() + 1e-12), v.shape)
           for k, v in base.items()}
    for n in CAM_OUT:
        mlo[n] = np.abs(rng.normal(100, 40, NCOL))
    return mli, mlo


def write_pair(dirpath, stamp, vset_name, seed):
    """A classic netCDF mli/mlo pair; state_v is stored [lev, ncol], as
    ingestion must transpose it back."""
    mli, mlo = raw_fields(vset_name, seed)
    for ab, d in (("mli", mli), ("mlo", mlo)):
        with netcdf_file(dirpath / f"E3SM-MMF.{ab}.{stamp}.nc", "w") as f:
            f.createDimension("ncol", NCOL)
            f.createDimension("lev", NLEV)
            for k, v in d.items():
                if k == "state_v":
                    f.createVariable(k, "d", ("lev", "ncol"))[:] = v.T
                else:
                    dims = ("ncol", "lev") if v.ndim == 2 else ("ncol",)
                    f.createVariable(k, "d", dims)[:] = v
    return mli, mlo


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("raw")
    grid = write_grid(root / "grid.nc")
    for vset_name in ("v1", "v2_rh", "v5"):
        sub = root / vset_name / "0001-02"
        sub.mkdir(parents=True)
        for i in range(2):
            write_pair(sub, f"0001-02-0{i + 1}-00000", vset_name, seed=i)
    return root, grid


def normalizers(vset_name, seed=3):
    vs = V.get(vset_name)
    rng = np.random.default_rng(seed)
    inl, outl = vs.inputs, vs.outputs
    stat = lambda names, lo, hi: {
        n: rng.uniform(lo, hi, NLEV if V.var_len(n) == NLEV else 1)
        for n in names}
    mean = stat(inl.names, -1, 1)
    maxv = {n: v + rng.uniform(1, 2, v.shape) for n, v in mean.items()}
    minv = {n: v - rng.uniform(1, 2, v.shape) for n, v in mean.items()}
    scale = stat(outl.names, 0.5, 2)
    return (LevelNormalizer.from_var_stats(vs, mean, maxv, minv, scale),
            JLevelNormalizer.from_var_stats(JV.get(vset_name), mean, maxv,
                                            minv, scale))


def pair_paths(root, vset_name, i=0):
    mli = (root / vset_name / "0001-02"
           / f"E3SM-MMF.mli.0001-02-0{i + 1}-00000.nc")
    return str(mli), str(mli).replace(".mli.", ".mlo.")


@pytest.mark.parametrize("vset_name", ["v1", "v2_rh", "v5"])
@pytest.mark.parametrize("norm", [False, True])
def test_pack_pair_equal(tree, vset_name, norm):
    root, gpath = tree
    grid, jgrid = Grid.from_file(gpath, device="cpu"), JGrid.from_file(gpath)
    nz, jnz = normalizers(vset_name) if norm else (None, None)
    mli, mlo = pair_paths(root, vset_name)
    got = ingest.pack_pair(mli, mlo, V.get(vset_name), grid, nz,
                           device="cpu")
    want = jingest.pack_pair(mli, mlo, JV.get(vset_name), jgrid, jnz)
    for g, w, what in zip(got, want, ("x_lev", "x_sfc", "y_lev", "y_sfc")):
        assert isinstance(g, np.ndarray)
        close(g, w, 1e-6, f"{vset_name} {what}")
    if vset_name == "v2_rh" and not norm:
        i_rh = V.get(vset_name).inputs.lev_names.index("state_rh")
        assert np.isfinite(got[0][..., i_rh]).all()
        assert got[0][..., i_rh].min() >= 0


@pytest.mark.parametrize("vset_name", ["v2_rh", "v5"])
def test_derive_missing_and_targets_equal(tree, vset_name):
    root, gpath = tree
    grid, jgrid = Grid.from_file(gpath, device="cpu"), JGrid.from_file(gpath)
    mli, mlo = raw_fields(vset_name, seed=7)
    got = ingest.derive_missing(mli, V.get(vset_name), grid, NCOL, NLEV,
                                device="cpu")
    want = jingest.derive_missing(mli, JV.get(vset_name), jgrid, NCOL, NLEV)
    assert sorted(got) == sorted(want)
    for k in want:
        close(np.asarray(got[k]), np.asarray(want[k]), 1e-6, k)
    # the relative humidity in float64, from the float64 mid pressure
    assert got["state_rh"].dtype == np.float64
    tg = ingest.build_targets(got, mlo, V.get(vset_name))
    tw = jingest.build_targets(want, mlo, JV.get(vset_name))
    assert list(tg) == list(tw)
    for k in tw:
        close(np.asarray(tg[k]), np.asarray(tw[k]), 1e-6, k)
    if vset_name == "v5":
        want_qn = ((mlo["state_q0002"] - mli["state_q0002"])
                   + (mlo["state_q0003"] - mli["state_q0003"])) / 1200.0
        np.testing.assert_array_equal(tg["ptend_qn"], want_qn)


def test_shape_fix_transposes():
    a = np.arange(NCOL * NLEV, dtype=np.float32).reshape(NLEV, NCOL)
    np.testing.assert_array_equal(ingest._shape_fix(a[None], NCOL, NLEV),
                                  jingest._shape_fix(a[None], NCOL, NLEV))
    assert ingest._shape_fix(a, NCOL, NLEV).shape == (NCOL, NLEV)


def test_pack_pair_on_the_card_by_default(tree):
    """The normalizer and the relative humidity run on the card unless
    the caller asks for the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    root, gpath = tree
    mli, mlo = pair_paths(root, "v2_rh")
    with pytest.raises(RuntimeError, match="CUDA"):
        ingest.pack_pair(mli, mlo, V.get("v2_rh"),
                         Grid.from_file(gpath, device="cpu"))


@pytest.mark.parametrize("vset_name", ["v1", "v5"])
@pytest.mark.parametrize("norm", [False, True])
def test_ingest_end_to_end_equal(tree, tmp_path, vset_name, norm):
    """The keeplev H5 of a split. With a normalizer JAX's ingest stops in
    its writer (it scrubs the read-only arrays its normalizer returns, in
    place), so the port's file is held to JAX's pack_pair of each file."""
    root, gpath = tree
    grid, jgrid = Grid.from_file(gpath, device="cpu"), JGrid.from_file(gpath)
    fl = filelist.FileLists(str(root / vset_name))
    jfl = jfilelist.FileLists(str(root / vset_name))
    for f in (fl, jfl):
        f.set_regexps("train", ["*/E3SM-MMF.mli.0001-*.nc"])
        f.set_stride_sample("train", 1)
    nz, jnz = normalizers(vset_name) if norm else (None, None)
    n = ingest.ingest(fl, V.get(vset_name), grid, str(tmp_path / "t.h5"),
                      normalizer=nz, device="cpu")
    assert n == 2 * NCOL
    r = KeeplevReader(str(tmp_path / "t.h5"))
    d = r.load_all()
    if norm:
        pairs = [jingest.pack_pair(f, jfl.output_path(f), JV.get(vset_name),
                                   jgrid, jnz)
                 for f in jfl.get_filelist("train")]
        jd = {k: np.concatenate([p[i] for p in pairs])
              for i, k in enumerate(("input_lev", "input_sca", "output_lev",
                                     "output_sca"))}
        vs = V.get(vset_name)
        assert r.varnames == {
            "input_lev": list(vs.inputs.lev_names),
            "input_sca": list(vs.inputs.sfc_names),
            "output_lev": list(vs.outputs.lev_names),
            "output_sca": list(vs.outputs.sfc_names)}
    else:
        assert n == jingest.ingest(jfl, JV.get(vset_name), jgrid,
                                   str(tmp_path / "j.h5"))
        jr = JKeeplevReader(str(tmp_path / "j.h5"))
        assert r.varnames == jr.varnames
        jd = jr.load_all()
    for k in jd:
        close(d[k], jd[k], 1e-6, k)


def test_save_as_npy_equal(tree, tmp_path):
    root, gpath = tree
    grid, jgrid = Grid.from_file(gpath, device="cpu"), JGrid.from_file(gpath)
    vs, jvs = V.get("v1"), JV.get("v1")
    T = 3
    rng = np.random.default_rng(0)
    inl, outl = vs.inputs, vs.outputs
    arrs = (rng.normal(0, 1, (T * NCOL, NLEV, inl.n_lev_vars)),
            rng.normal(0, 1, (T * NCOL, inl.n_sfc_vars)),
            rng.normal(0, 1, (T * NCOL, NLEV, outl.n_lev_vars)),
            rng.normal(0, 1, (T * NCOL, outl.n_sfc_vars)))
    arrs = tuple(a.astype(np.float32) for a in arrs)
    arrs[2][0, 0, 0] = np.nan
    kw = dict(save_h5=True, save_latlontime=True,
              dates=["0001-02-01-00000", "0001-02-01-01200"])
    got = ingest.save_as_npy(arrs, vs, str(tmp_path / "t"), "val",
                             grid=grid, **kw)
    want = jingest.save_as_npy(arrs, jvs, str(tmp_path / "j"), "val",
                               grid=jgrid, **kw)
    assert [os.path.basename(p) for p in got] \
        == [os.path.basename(p) for p in want] and len(got) == 5
    for g, w in zip(got, want):
        if g.endswith(".npy"):
            assert filecmp.cmp(g, w, shallow=False)
        elif g.endswith(".h5"):
            with h5py.File(g) as a, h5py.File(w) as b:
                np.testing.assert_array_equal(a["data"][:], b["data"][:])
                assert a["data"].dtype == b["data"].dtype
        else:
            with open(g, "rb") as a, open(w, "rb") as b:
                assert pickle.load(a) == pickle.load(b)
    # from a keeplev H5 path too, without the pickle
    with h5py.File(tmp_path / "k.h5", "w") as f:
        for k, a in zip(("input_lev", "input_sca", "output_lev",
                         "output_sca"), arrs):
            f.create_dataset(k, data=a)
    got = ingest.save_as_npy(str(tmp_path / "k.h5"), vs, str(tmp_path / "t2"))
    want = jingest.save_as_npy(str(tmp_path / "k.h5"), jvs,
                               str(tmp_path / "j2"))
    for g, w in zip(got, want):
        assert filecmp.cmp(g, w, shallow=False)


# ------------------------------------------------------------ tsstore


def keeplev_arrays(n, seed=0):
    rng = np.random.default_rng(seed)
    return {"input_lev": rng.normal(0, 1, (n, NLEV, 2)).astype(np.float32),
            "input_sca": rng.normal(0, 1, (n, 4)).astype(np.float32),
            "output_lev": rng.normal(0, 1, (n, NLEV, 2)).astype(np.float32),
            "output_sca": rng.normal(0, 1, (n, 8)).astype(np.float32)}


def test_tsstore_cross_read_write(tmp_path):
    pytest.importorskip("tensorstore")
    from climsim_tpu.data import tsstore as jtsstore
    from climsim_tpu_torch.data import tsstore
    n = 100
    arrays = keeplev_arrays(n)
    arrays["output_sca"][3, 2] = np.inf          # scrubbed to 0 on write
    shapes = {k: v.shape[1:] for k, v in arrays.items()}
    names = {"input_lev": ["state_t", "state_q0001"]}
    for writer, reader, tag in ((jtsstore, tsstore, "jt"),
                                (tsstore, jtsstore, "tj")):
        root = str(tmp_path / tag)
        st = writer.TsKeeplevStore(root).create(n, shapes, names,
                                                rows_per_chunk=32)
        # copies: JAX's writer scrubs the arrays it is given in place
        st.write_rows(0, **{k: v[:60].copy() for k, v in arrays.items()})
        st.write_rows(60, **{k: v[60:].copy() for k, v in arrays.items()})
        got = reader.TsKeeplevStore(root).open()
        assert got.n == n and got.varnames == names
        rows = got.read_rows(10, 90)
        want = jtsstore.TsKeeplevStore(root).open().read_rows(10, 90)
        for k in arrays:
            np.testing.assert_array_equal(rows[k], want[k])
        np.testing.assert_array_equal(rows["input_lev"],
                                      arrays["input_lev"][10:90])
        assert np.isinf(arrays["output_sca"][3, 2])
        assert got.read_rows(0, 10)["output_sca"][3, 2] == 0.0
        chunks = list(got.iter_chunks(32))
        assert [len(c["input_sca"]) for c in chunks] == [32, 32, 32, 4]


def test_tsstore_from_h5_equal(tmp_path):
    pytest.importorskip("tensorstore")
    from climsim_tpu.data import tsstore as jtsstore
    from climsim_tpu_torch.data import tsstore
    from climsim_tpu_torch.data.h5store import KeeplevWriter
    arrays = keeplev_arrays(70, seed=1)
    h5p = str(tmp_path / "x.h5")
    with KeeplevWriter(h5p, varnames={"input_sca": ["a", "b", "c", "d"]}) \
            as w:
        w.append(*[arrays[k] for k in ("input_lev", "input_sca",
                                       "output_lev", "output_sca")])
    tsstore.from_h5(h5p, str(tmp_path / "t"), rows_per_chunk=16)
    jtsstore.from_h5(h5p, str(tmp_path / "j"), rows_per_chunk=16)
    got = tsstore.TsKeeplevStore(str(tmp_path / "t")).open()
    want = jtsstore.TsKeeplevStore(str(tmp_path / "j")).open()
    assert got.meta == want.meta
    a, b = got.read_rows(0, 70), want.read_rows(0, 70)
    for k in arrays:
        np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a[k], arrays[k])
