"""The port's training-data pipeline against the JAX package's on the CPU:
the synthetic physics and time series (fed JAX's draws), the keeplev H5
store (round trips both ways), the chunk loaders (the same chunks in the
same order), the device prefetch, the preprocessing chain, the
normalizers (on netCDF files fabricated with h5py), the flat layout and
the epoch scoreboard.

JAX runs with x64 off, as its CLI does. ``make_timeseries`` is held to
JAX's with jit disabled: XLA's jitted CPU code evaluates tanh and exp by
its own approximations, which move the synthetic tendencies by up to
3e-3 of their scale against the same function run op by op (and against
this port) at these inputs."""

import os

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climsim_tpu import variables as JV
from climsim_tpu.data import h5store as JH
from climsim_tpu.data import ingest as JI
from climsim_tpu.data import loader as JL
from climsim_tpu.data import normalization as JN
from climsim_tpu.data import preprocess as JP
from climsim_tpu.data import synthetic as JS
from climsim_tpu.grid import Grid as JaxGrid
from climsim_tpu.train import epoch_metrics as JM
from climsim_tpu_torch import Grid
from climsim_tpu_torch import variables as V
from climsim_tpu_torch.data import h5store as TH
from climsim_tpu_torch.data import ingest as TI
from climsim_tpu_torch.data import loader as TL
from climsim_tpu_torch.data import normalization as TN
from climsim_tpu_torch.data import preprocess as TP
from climsim_tpu_torch.data import synthetic as TS
from climsim_tpu_torch.train import epoch_metrics as TM

NCOL, NLEV, STEPS = 32, 60, 8


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """These CPU runs are small: two intra-op threads a worker keep the
    suite's parallel workers from oversubscribing the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ts_draws(key, nsteps):
    """The port's make_timeseries draw function giving JAX's normals
    (synthetic.py's module docstring names the keys)."""
    k0, kscan = jax.random.split(key)
    keys32 = jax.random.split(k0, 32)
    step_keys = jax.random.split(kscan, nsteps)

    def draw(k, shape):
        if k[0] == "k0":
            i = k[1]
            kk = keys32[i] if isinstance(i, int) else \
                jax.random.split(keys32[i[0]])[i[1]]
        else:
            k1, k2, k3 = jax.random.split(step_keys[k[1]], 3)
            kk = {"k1": lambda: jax.random.split(k1, 4)[k[2]],
                  "k2": lambda: k2, "k3": lambda: k3}[k[0]]()
        return torch.tensor(np.asarray(jax.random.normal(kk, shape,
                                                         jnp.float32)))
    return draw


def _close_per_channel(got, want, frac):
    """|got - want| <= frac x each last-axis channel's largest |want|."""
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape and got.dtype == want.dtype
    axes = tuple(range(want.ndim - 1))
    scale = np.abs(want).max(axis=axes)
    err = np.abs(got - want).max(axis=axes)
    assert (err <= frac * scale).all(), (err / np.maximum(scale, 1e-30))


@pytest.mark.parametrize("vset,gcol,flat", [("v4_rnn", NCOL, False),
                                            ("v1", NCOL // 2, True)])
def test_make_timeseries_matches_jax(vset, gcol, flat):
    """v4_rnn keeplev on a grid of the data's columns (the CLI's layout)
    and v1 flat on a smaller grid (the linspace lat/lon branch): every
    channel within 1e-5 of its scale after 8 steps of state evolution."""
    key = jax.random.PRNGKey(1)
    with jax.enable_x64(False), jax.disable_jit():
        want = JS.make_timeseries(key, JS.SyntheticConfig(vset_name=vset,
                                                          ncol=NCOL),
                                  JaxGrid.synthetic(gcol, NLEV), STEPS,
                                  flat=flat)
        want = [np.asarray(a) for a in want]
    got = TS.make_timeseries(None, TS.SyntheticConfig(vset_name=vset,
                                                      ncol=NCOL),
                             Grid.synthetic(gcol, NLEV), STEPS, flat=flat,
                             draw=_ts_draws(key, STEPS))
    assert len(got) == len(want) == (2 if flat else 4)
    for g, w in zip(got, want):
        _close_per_channel(g, w, 1e-5)


@pytest.mark.parametrize("noise", [0.0, 0.02])
def test_synthetic_physics_matches_jax(noise):
    """From JAX's state and noise draws, every target within 1e-6 of its
    scale (JAX op by op; see the module docstring)."""
    key = jax.random.PRNGKey(5)
    with jax.enable_x64(False), jax.disable_jit():
        cfg = JS.SyntheticConfig(vset_name="v4_rnn", ncol=NCOL,
                                 target_noise=noise)
        jg = JaxGrid.synthetic(NCOL, NLEV)
        state = JS.generate_state(jax.random.PRNGKey(0), cfg, jg)
        want = JS.synthetic_physics(state, jg, key, cfg)
        ks = jax.random.split(key, 4)
        seen = []

        def draw(j, shape):
            seen.append(j)
            return torch.tensor(np.asarray(jax.random.normal(ks[j], shape,
                                                             jnp.float32)))
        got = TS.synthetic_physics(
            {k: torch.tensor(np.asarray(v)) for k, v in state.items()},
            Grid.synthetic(NCOL, NLEV), None,
            TS.SyntheticConfig(vset_name="v4_rnn", ncol=NCOL,
                               target_noise=noise), draw=draw)
    assert list(got) == list(want)
    assert seen == ([0, 1, 2, 3] if noise else [])
    for k in want:
        w = np.asarray(want[k])
        np.testing.assert_allclose(got[k].numpy(), w, rtol=0,
                                   atol=1e-6 * np.abs(w).max(), err_msg=k)


def test_pack_matches_jax():
    cfg = JS.SyntheticConfig(vset_name="v4_rnn", ncol=NCOL)
    with jax.enable_x64(False):
        jg = JaxGrid.synthetic(NCOL, NLEV)
        st = JS.generate_state(jax.random.PRNGKey(0), cfg, jg)
        tg = JS.synthetic_physics(st, jg, jax.random.PRNGKey(1), cfg)
        want_k = JS.pack_keeplev(st, tg, JV.get("v4_rnn"))
        want_f = JS.pack_flat(st, tg, JV.get("v4_rnn"))
    t = lambda d: {k: torch.tensor(np.asarray(v)) for k, v in d.items()}
    got_k = TS.pack_keeplev(t(st), t(tg), V.get("v4_rnn"))
    got_f = TS.pack_flat(t(st), t(tg), V.get("v4_rnn"))
    for g, w in zip(got_k + got_f, want_k + want_f):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_make_timeseries_seeded_generator():
    """A seed gives the same series twice, another seed another one."""
    cfg, grid = TS.SyntheticConfig(vset_name="v4_rnn", ncol=NCOL), \
        Grid.synthetic(NCOL, NLEV)
    a = TS.make_timeseries(torch.Generator().manual_seed(0), cfg, grid, 3,
                           flat=False)
    b = TS.make_timeseries(torch.Generator().manual_seed(0), cfg, grid, 3,
                           flat=False)
    c = TS.make_timeseries(torch.Generator().manual_seed(1), cfg, grid, 3,
                           flat=False)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[2], c[2])
    assert all(bool(torch.isfinite(x).all()) for x in a)


def _series(T=13, B=4, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return f(T, B, 5, 7), f(T, B, 3), f(T, B, 5, 6), f(T, B, 2), f(T, B)


@pytest.mark.parametrize("prev", [(0, 0), (6, 5), (2, 0)])
@pytest.mark.parametrize("shuffle", [True, False])
@pytest.mark.parametrize("as_tensor", [False, True])
def test_keeplev_chunks_match_jax(prev, shuffle, as_tensor):
    """The same chunks in the same order (np.random.default_rng(seed)),
    bit for bit, with and without the previous-step channels, from numpy
    arrays and from tensors (which stay tensors)."""
    arrays = _series()
    kw = dict(chunk_size=3, seed=7, shuffle=shuffle,
              include_prev_inputs=prev[0], include_prev_outputs=prev[1])
    want = list(JL.keeplev_chunks(*arrays, **kw))
    src = [torch.from_numpy(a) for a in arrays] if as_tensor else arrays
    got = list(TL.keeplev_chunks(*src, **kw))
    assert len(got) == len(want) == (13 - (1 if any(prev) else 0)) // 3
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert isinstance(g[k], torch.Tensor) == as_tensor
            gv = g[k].numpy() if as_tensor else g[k]
            np.testing.assert_array_equal(gv, np.asarray(w[k]), err_msg=k)


def test_chunkize_and_flat_batches_match_jax():
    for shuffle in (True, False):
        a = JL.chunkize(20, 6, np.random.default_rng(3), shuffle)
        b = TL.chunkize(20, 6, np.random.default_rng(3), shuffle)
        assert [x.tolist() for x in a] == [x.tolist() for x in b]
    x = np.arange(50, dtype=np.float32).reshape(25, 2)
    y = np.arange(25, dtype=np.float32)
    for kw in (dict(seed=1), dict(shuffle=False, drop_remainder=False)):
        for (gx, gy), (wx, wy) in zip(TL.flat_batches(x, y, 4, **kw),
                                      JL.flat_batches(x, y, 4, **kw)):
            np.testing.assert_array_equal(gx, wx)
            np.testing.assert_array_equal(gy, wy)


def _write_store(path, T=10, B=4, seed=0):
    x_lev, x_sfc, y_lev, y_sfc, _ = _series(T, B, seed)
    JH.write_timeseries(path, x_lev.copy(), x_sfc.copy(), y_lev.copy(),
                        y_sfc.copy(), varnames={"input_lev": list("abcdefg")})
    return x_lev, x_sfc, y_lev, y_sfc


@pytest.mark.parametrize("prev", [(0, 0), (6, 5)])
def test_stream_keeplev_chunks_matches_jax(tmp_path, prev):
    """From one store, the same chunks as JAX's stream, with the default
    transform and within a step range."""
    path = str(tmp_path / "s.h5")
    _write_store(path)
    read = TH.KeeplevReader(path).load_slice
    for rng_kw in (dict(), dict(t_start=2, t_stop=9)):
        kw = dict(chunk_size=2, seed=4, include_prev_inputs=prev[0],
                  include_prev_outputs=prev[1], **rng_kw)
        want = list(JL.stream_keeplev_chunks(
            JH.KeeplevReader(path).load_slice, 10, 4, **kw))
        got = list(TL.stream_keeplev_chunks(read, 10, 4, **kw))
        assert len(got) == len(want) > 0
        for g, w in zip(got, want):
            for k in w:
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def test_stream_to_device_and_errors(tmp_path):
    """to_device on the CPU gives tensors; an error raised by the reader
    reaches the consumer."""
    path = str(tmp_path / "s.h5")
    _write_store(path)
    read = TH.KeeplevReader(path).load_slice
    got = list(TL.stream_keeplev_chunks(read, 10, 4, chunk_size=3, seed=1,
                                        to_device=True, device="cpu"))
    want = list(TL.stream_keeplev_chunks(read, 10, 4, chunk_size=3, seed=1))
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert all(isinstance(v, torch.Tensor) for v in g.values())
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(), w[k])

    def broken(lo, hi):
        raise OSError("store unreadable")
    with pytest.raises(OSError, match="store unreadable"):
        list(TL.stream_keeplev_chunks(broken, 10, 4, chunk_size=3))


def test_prefetch_to_device_on_cpu():
    """Items arrive in order as tensors (dicts and tuples kept), at most
    ``size`` ahead of the consumer, and an error in the source reaches the
    consumer after the items before it."""
    pulled = []

    def source():
        for i in range(6):
            pulled.append(i)
            yield {"a": np.full(3, i, np.float32)}, (np.arange(i + 1),)
    it = TL.prefetch_to_device(source(), size=2, device="cpu")
    first = next(it)
    assert isinstance(first[0]["a"], torch.Tensor) and \
        first[0]["a"].tolist() == [0, 0, 0]
    rest = list(it)
    assert [r[1][0].tolist() for r in rest] == [list(range(i + 1))
                                                for i in range(1, 6)]
    assert pulled == list(range(6))

    def failing():
        yield np.zeros(2)
        raise ValueError("bad batch")
    it = TL.prefetch_to_device(failing(), device="cpu")
    assert next(it).tolist() == [0.0, 0.0]
    with pytest.raises(ValueError, match="bad batch"):
        next(it)


def test_prefetch_refuses_cuda_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        next(TL.prefetch_to_device(iter([np.zeros(2)])))


def test_h5_store_round_trips(tmp_path):
    """JAX writes, the port reads; the port writes (and concatenates), JAX
    reads: the same arrays and varnames; NaN/Inf scrubbed to 0 without
    touching the caller's arrays."""
    jpath = str(tmp_path / "j.h5")
    x_lev, x_sfc, y_lev, y_sfc = _write_store(jpath)
    r = TH.KeeplevReader(jpath)
    assert r.n == 40 and r.varnames["input_lev"] == list("abcdefg")
    d = r.load_all()
    np.testing.assert_array_equal(d["input_lev"], x_lev.reshape(40, 5, 7))
    np.testing.assert_array_equal(r.load_slice(8, 12)["output_sca"],
                                  y_sfc.reshape(40, 2)[8:12])
    assert sum(c["input_sca"].shape[0] for c in r.iter_chunks(16)) == 40

    x_bad = x_lev.copy()
    x_bad[0, 0, 0, 0] = np.nan
    tpath = str(tmp_path / "t.h5")
    assert TH.write_timeseries(tpath, torch.from_numpy(x_bad), x_sfc,
                               y_lev, y_sfc) == 10
    assert np.isnan(x_bad[0, 0, 0, 0])
    cpath = str(tmp_path / "c.h5")
    TH.concatenate([tpath, jpath], cpath)
    w = JH.KeeplevReader(cpath).load_all()
    assert w["input_lev"].shape == (80, 5, 7)
    want = x_lev.reshape(40, 5, 7).copy()
    want[0, 0, 0] = 0.0
    np.testing.assert_array_equal(w["input_lev"][:40], want)
    np.testing.assert_array_equal(w["input_lev"][40:], x_lev.reshape(40, 5, 7))
    with h5py.File(cpath) as f:
        assert f["input_lev"].compression == "lzf"


@pytest.mark.parametrize("cfg", [
    dict(cld_inp_transformation="none"),
    dict(rh_prune=True, rh_input_to_q=True, cld_inp_transformation="sqrt",
         qinput_prune=True),
    dict(rh_input_to_q=True, include_q_input=True,
         cld_inp_transformation="exp"),
    dict(v4_to_v5_inputs=True, cld_inp_transformation="exp",
         qinput_prune=True, qinput_prune_lev=10),
    dict(v4_to_v5_inputs=True, cld_inp_transformation="sqrt")])
def test_preprocess_matches_jax(cfg):
    """The chain on synthetic v4_rnn inputs (a SNOWHICE sentinel planted),
    with fitted lambdas: the same arrays to 1e-6 relative (the rh -> q
    conversion runs through each package's thermodynamics in float32)."""
    with jax.enable_x64(False):
        jg = JaxGrid.synthetic(NCOL, NLEV)
        xl, xs, _, _ = JS.make_timeseries(
            jax.random.PRNGKey(2), JS.SyntheticConfig(vset_name="v4_rnn",
                                                      ncol=NCOL), jg, 3,
            flat=False)
    xl, xs = np.array(xl), np.array(xs)
    xs[0, 0, 15] = 2e10
    lbd = dict(lbd_qc=JN.fit_exp_lambdas(xl[..., 2]),
               lbd_qi=JN.fit_exp_lambdas(xl[..., 3]),
               lbd_qn=JN.fit_exp_lambdas(xl[..., 2] + xl[..., 3]))
    hyam, hybm = np.asarray(jg.hyam), np.asarray(jg.hybm)
    with jax.enable_x64(False):
        want = JP.preprocess_level_inputs(xl, xs, hyam, hybm,
                                          JP.PreprocessConfig(**cfg), **lbd)
    got = TP.preprocess_level_inputs(xl, xs, hyam, hybm,
                                     TP.PreprocessConfig(**cfg), **lbd)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-30)
    assert got[2][0, 0, 15] == -1.0
    with pytest.raises(ValueError):
        TP.PreprocessConfig(cld_inp_transformation="log")


def _write_nc(path, stats):
    """A netCDF4/HDF5 file of 1-D variables, as the ClimSim norm files."""
    with h5py.File(path, "w") as f:
        for k, v in stats.items():
            f.create_dataset(k, data=np.asarray(v, np.float64))


@pytest.fixture(scope="module")
def norm_files(tmp_path_factory):
    """input_{mean,max,min} and output_scale files for v4_rnn: per-level
    level variables (CH4 with zeros in its div in the lower levels),
    scalar surface variables."""
    root = tmp_path_factory.mktemp("norms")
    vs = JV.get("v4_rnn")
    rng = np.random.default_rng(0)
    mean, mx, mn, sc = {}, {}, {}, {}
    for n in vs.inputs.lev_names:
        m = rng.standard_normal(NLEV)
        mean[n], mn[n] = m, m - rng.uniform(0.5, 2, NLEV)
        mx[n] = m + rng.uniform(0.5, 2, NLEV)
    mx["pbuf_CH4"][30:] = mn["pbuf_CH4"][30:] = 1.0
    for n in vs.inputs.sfc_names:
        mean[n], mn[n], mx[n] = [rng.standard_normal()], [-3.0], [3.0]
    mx["tm_state_ps"] = mn["tm_state_ps"] = [5.0]
    for n in vs.outputs.lev_names:
        sc[n] = rng.uniform(1, 10, NLEV)
    for n in vs.outputs.sfc_names:
        sc[n] = [rng.uniform(1, 10)]
    paths = {}
    for tag, d in (("input_mean", mean), ("input_max", mx),
                   ("input_min", mn), ("output_scale", sc)):
        paths[tag] = str(root / f"{tag}.nc")
        _write_nc(paths[tag], d)
    return paths


@pytest.mark.parametrize("kw", [dict(), dict(snowhice_fix=False,
                                             remove_past_sfc=True)])
def test_reference_level_normalizer_matches_jax(norm_files, kw):
    vs_j, vs_t = JV.get("v4_rnn"), V.get("v4_rnn")
    files = [norm_files[k] for k in ("input_mean", "input_max", "input_min",
                                     "output_scale")]
    with jax.enable_x64(False):
        want = JN.reference_level_normalizer(vs_j, *files, **kw)
    got = TN.reference_level_normalizer(vs_t, *files, **kw)
    for name in ("mean_lev", "div_lev", "mean_sfc", "div_sfc", "scale_lev",
                 "scale_sfc"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert (got.div_lev > 0).all()
    assert TN.reference_norm_paths(*files) == JN.reference_norm_paths(*files)
    # the defaults: the same files in the ClimSim tree, relative here
    for k, v in TN.reference_norm_paths().items():
        assert v == os.path.join(TN.REF_NORM_DIR,
                                 os.path.relpath(JN.reference_norm_paths()[k],
                                                 JN.REF_NORM_DIR))


def test_reference_normalizer_names_missing_file(tmp_path):
    missing = str(tmp_path / "nope.nc")
    with pytest.raises(FileNotFoundError, match="nope.nc"):
        TN.reference_level_normalizer(V.get("v4_rnn"), input_mean=missing)
    with pytest.raises(FileNotFoundError, match="input_mean_v4_pervar.nc"):
        TN.reference_level_normalizer(V.get("v4_rnn"))


@pytest.mark.parametrize("per_level", [True, False])
def test_normalizers_from_files_match_jax(norm_files, per_level):
    files = [norm_files[k] for k in ("input_mean", "input_max", "input_min",
                                     "output_scale")]
    with jax.enable_x64(False):
        wl = JN.LevelNormalizer.from_files(JV.get("v4_rnn"), *files,
                                           per_level=per_level)
        wf = JN.Normalizer.from_files(JV.get("v4_rnn"), *files)
    gl = TN.LevelNormalizer.from_files(V.get("v4_rnn"), *files,
                                       per_level=per_level)
    gf = TN.Normalizer.from_files(V.get("v4_rnn"), *files)
    for g, w in ((gl, wl), (gf, wf)):
        for f in g.__dataclass_fields__:
            np.testing.assert_array_equal(getattr(g, f).numpy(),
                                          np.asarray(getattr(w, f)))
    x = torch.randn(2, NLEV, 15)
    xs = torch.randn(2, 24)
    back = gl.denormalize(*gl.normalize(x, xs))
    torch.testing.assert_close(back[0], x, rtol=1e-5, atol=1e-5)
    assert gl.to("cpu").mean_lev.device.type == "cpu"
    ident = TN.LevelNormalizer.identity(V.get("v4_rnn"))
    assert torch.equal(ident.normalize(x, xs)[0], x)


def test_exp_lambdas_and_norm_txt_match_jax(tmp_path):
    q = np.abs(np.random.default_rng(1).standard_normal((50, 60))) * 1e-6
    q[:, :5] = 0.0
    lbd = TN.fit_exp_lambdas(q)
    np.testing.assert_array_equal(lbd, JN.fit_exp_lambdas(q))
    assert (lbd[:5] == 1e7).all()
    TN.save_exp_lambdas(lbd, str(tmp_path / "l.txt"))
    np.testing.assert_array_equal(TN.load_exp_lambdas(str(tmp_path / "l.txt")),
                                  JN.load_exp_lambdas(str(tmp_path / "l.txt")))
    np.savetxt(tmp_path / "w.txt", lbd[None])
    np.testing.assert_array_equal(TN.load_exp_lambdas(str(tmp_path / "w.txt")),
                                  JN.load_exp_lambdas(str(tmp_path / "w.txt")))
    mean, mx, mn, sc = (np.arange(4.0) + i for i in range(4))
    TN.save_norm_txt(TN.Normalizer.from_arrays(mean, mx, mn, sc),
                     str(tmp_path))
    tdir = tmp_path / "jax"
    tdir.mkdir()
    JN.save_norm_txt(JN.Normalizer.from_arrays(mean, mx, mn, sc), str(tdir))
    for f in ("inp_sub.txt", "inp_div.txt", "out_scale.txt"):
        assert open(tmp_path / f).read() == open(tdir / f).read()


def test_keeplev_to_flat_matches_jax():
    rng = np.random.default_rng(2)
    lay_j, lay_t = JV.get("v4_rnn").outputs, V.get("v4_rnn").outputs
    xl = rng.standard_normal((5, NLEV, 6)).astype(np.float32)
    xs = rng.standard_normal((5, 8)).astype(np.float32)
    np.testing.assert_array_equal(TI.keeplev_to_flat(xl, xs, lay_t),
                                  JI.keeplev_to_flat(xl, xs, lay_j))


@pytest.mark.parametrize("with_state", [False, True])
def test_epoch_metrics_match_jax(with_state):
    """The scoreboard from tensors against JAX's from the same arrays:
    every key, each value within 1e-5 relative (float32 conservation
    residuals) or 1e-12 of the numpy statistics."""
    rng = np.random.default_rng(3)
    N = 64
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    true_l = f(N, NLEV, 6) * 1e-5
    pred_l = true_l + f(N, NLEV, 6) * 3e-6
    true_s, pred_s = np.abs(f(N, 8)) * 1e-7, np.abs(f(N, 8)) * 1e-7
    sp = 1e5 + 1e3 * f(N)
    g = JaxGrid.synthetic(4, NLEV)
    hyai, hybi = np.asarray(g.hyai), np.asarray(g.hybi)
    xd = np.abs(f(N, NLEV, 15)) * 1e-3 if with_state else None
    with jax.enable_x64(False):
        want = JM.epoch_metrics(jnp.asarray(pred_l), jnp.asarray(pred_s),
                                jnp.asarray(true_l), jnp.asarray(true_s),
                                jnp.asarray(sp), hyai, hybi, x_denorm=xd)
    t = lambda a: torch.from_numpy(np.array(a))
    got = TM.epoch_metrics(t(pred_l), t(pred_s), t(true_l), t(true_s), t(sp),
                           t(hyai), t(hybi),
                           x_denorm=None if xd is None else t(xd))
    assert list(got) == list(want)
    for k, w in want.items():
        rtol = 1e-5 if k in ("h_conservation", "water_conservation",
                             "cldpath_err") else 1e-12
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(w),
                                   rtol=rtol, atol=1e-30, err_msg=k)
    # the ensemble branch: three members' predictions
    ens = np.stack([pred_l, pred_l + f(N, NLEV, 6) * 2e-6,
                    pred_l - f(N, NLEV, 6) * 1e-6])
    with jax.enable_x64(False):
        want = JM.epoch_metrics(jnp.asarray(pred_l), jnp.asarray(pred_s),
                                jnp.asarray(true_l), jnp.asarray(true_s),
                                jnp.asarray(sp), hyai, hybi,
                                ens_pred_lev=jnp.asarray(ens))
    got = TM.epoch_metrics(t(pred_l), t(pred_s), t(true_l), t(true_s), t(sp),
                           t(hyai), t(hybi), ens_pred_lev=t(ens))
    assert {"spread_skill", "q_err_corr"} <= set(got)
    assert list(got) == list(want)
    for k in ("spread_skill", "q_err_corr"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, err_msg=k)
