"""The port's data pipeline against the JAX package's, bit for bit:
``load_constants`` on an aux directory the test writes, ``fastpack`` on
both routes (the native library and numpy), the h5py netCDF reader on files
the test writes (int16-packed with ``expver`` and unpacked), ``stack_state``,
``date_keys`` against the JAX (pandas) version, the file-backed and
synthetic datasets, ``Loader`` batches (a short last batch, shuffling,
process sharding, the device put in the consumer) and
``compute_statistics``.

The JAX package's fastpack is pointed at the port's library (or at its
numpy route where the port's did not build), so both packages run one
route in each comparison."""

import os
import threading
from datetime import datetime

import numpy as np
import pytest
import torch

from pangu_tpu.config import DataConfig as JaxDataConfig
from pangu_tpu.config import ModelConfig as JaxModelConfig
from pangu_tpu.data import constants as jax_constants
from pangu_tpu.data import era5 as jax_era5
from pangu_tpu.data import fastpack as jax_fastpack
from pangu_tpu_torch.config import TINY, DataConfig, ModelConfig
from pangu_tpu_torch.data import constants, era5, fastpack

GEO = dict(levels=3, lat=12, lon=48, depths=(2, 2, 2, 2),
           heads=(2, 2, 2, 2), dims=(8, 16, 16, 8))
MCFG, JAX_MCFG = ModelConfig(**GEO), JaxModelConfig(**GEO)


@pytest.fixture
def native(monkeypatch):
    """The port's native library, JAX's fastpack bound to it."""
    lib = fastpack.load()
    if lib is None:
        pytest.fail("native/fastpack.cpp did not build with g++")
    monkeypatch.setattr(jax_fastpack, "_lib", lib)
    return lib


@pytest.fixture
def numpy_route(monkeypatch):
    monkeypatch.setattr(fastpack, "load", lambda: None)
    monkeypatch.setattr(jax_fastpack, "_lib", None)
    monkeypatch.setattr(jax_fastpack, "_tried", True)


@pytest.fixture(params=["native", "numpy"])
def route(request):
    request.getfixturevalue("native" if request.param == "native"
                            else "numpy_route")
    assert fastpack.route() == request.param
    return request.param


def _equal(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# constants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("padded_masks", [False, True])
def test_load_constants_matches_jax(tmp_path, padded_masks):
    cfg, r = TINY, np.random.default_rng(0)
    lat = cfg.lat_padded if padded_masks else cfg.lat
    files = {
        "surface_mean.npy": r.normal(size=(4,)),
        "surface_std.npy": r.uniform(0.5, 2, size=(4,)),
        "upper_mean.npy": r.normal(size=(cfg.levels, 1, 1, 5)),
        "upper_std.npy": r.uniform(0.5, 2, size=(cfg.levels, 1, 1, 5)),
        "constantMaks3.npy": r.normal(size=(1, 3, lat, cfg.lon)),
        "Constant_17_output_0.npy": r.normal(size=(cfg.levels, 1, cfg.lat,
                                                   cfg.lon)),
    }
    for name, arr in files.items():
        np.save(tmp_path / name, arr.astype(np.float32))
    want = jax_constants.get_constants(str(tmp_path),
                                       JaxModelConfig(**_tiny_geo()))
    got = constants.get_constants(str(tmp_path), cfg)
    assert set(got) == set(want)
    for k in want:
        _equal(got[k], want[k])
    # upper stats flipped into the canonical level order, index 0 = 1000 hPa
    np.testing.assert_array_equal(got["upper_mean"][:, 0, 0, 0],
                                  files["upper_mean.npy"][-1, 0, 0]
                                  .astype(np.float32))


def _tiny_geo():
    return dict(levels=TINY.levels, lat=TINY.lat, lon=TINY.lon,
                depths=TINY.depths, heads=TINY.heads, dims=TINY.dims)


def test_get_constants_without_aux_is_synthetic():
    got = constants.get_constants(None, TINY)
    want = constants.synthetic_constants(TINY)
    for k in want:
        _equal(got[k], want[k])


# ---------------------------------------------------------------------------
# fastpack
# ---------------------------------------------------------------------------

def test_fastpack_matches_jax(route):
    r = np.random.default_rng(1)
    ints = r.integers(-32768, 32767, size=(3, 70, 90)).astype(np.int16)
    ints[0, 0, :5] = -32767
    for fill in (None, -32767):
        _equal(fastpack.unpack_i16(ints, 0.0123, 271.5, fill),
               jax_fastpack.unpack_i16(ints, 0.0123, 271.5, fill))
    fields = [r.normal(size=(13, 30, 40)).astype(np.float32) for _ in range(5)]
    _equal(fastpack.stack_flip(fields), jax_fastpack.stack_flip(fields))
    x = r.normal(size=(5, 13, 30, 40)).astype(np.float32)
    mean = r.normal(size=(5, 13, 1, 1)).astype(np.float32)
    std = r.uniform(0.5, 2, size=(5, 13, 1, 1)).astype(np.float32)
    _equal(fastpack.normalize(x, mean, std),
           jax_fastpack.normalize(x, mean, std))


def test_fastpack_native_build_lands_in_the_port(native):
    assert fastpack.route() == "native"
    path = os.path.realpath(native._name)
    assert path.startswith(str(fastpack.BUILD_DIR))
    assert "native" + os.sep not in os.path.relpath(path, fastpack._ROOT)


# ---------------------------------------------------------------------------
# netCDF reader (the recipe of tests/test_data.py, copied)
# ---------------------------------------------------------------------------

def _write_fake_nc(path, varnames, shape, when: datetime, *, packed: bool,
                   expver: bool, rng, times=None):
    """A netCDF4-flavoured HDF5 file like the ERA5 downloads."""
    import h5py
    hours = int((np.datetime64(when, "s")
                 - np.datetime64("1900-01-01", "s")) / np.timedelta64(1, "h"))
    times = [hours - 6, hours] if times is None else times
    with h5py.File(path, "w") as f:
        t = f.create_dataset("time", data=np.asarray(times, dtype=np.int32))
        t.attrs["units"] = "hours since 1900-01-01 00:00:00.0"
        if expver:
            f.create_dataset("expver", data=np.asarray([1, 5], np.int32))
        for v in varnames:
            full = np.stack([rng.normal(size=shape).astype(np.float32) * 10
                             + 100 for _ in times])
            if expver:
                full = np.stack([full * 0, full], axis=1)  # expver axis
            if packed:
                scale, offset = 0.01, 100.0
                ints = np.round((full - offset) / scale).astype(np.int16)
                d = f.create_dataset(v, data=ints)
                d.attrs["scale_factor"] = np.float64(scale)
                d.attrs["add_offset"] = np.float64(offset)
                d.attrs["_FillValue"] = np.int16(-32767)
            else:
                f.create_dataset(v, data=full)


@pytest.mark.parametrize("packed,expver", [(False, False), (True, True)])
def test_netcdf_reader_matches_jax(tmp_path, route, packed, expver):
    when = datetime(2018, 1, 3, 12)
    path = str(tmp_path / "surface_201801.nc")
    _write_fake_nc(path, ["msl", "u10"], (5, 8), when, packed=packed,
                   expver=expver, rng=np.random.default_rng(0))
    got = era5.read_netcdf_fields(path, ["msl", "u10"], when)
    want = jax_era5.read_netcdf_fields(path, ["msl", "u10"], when)
    for v in ("msl", "u10"):
        _equal(got[v], want[v])
    with pytest.raises(KeyError):
        era5.read_netcdf_fields(path, ["msl"], datetime(2019, 1, 1))


def test_stack_state_matches_jax(route):
    r = np.random.default_rng(2)
    upper = {v: r.normal(size=(4, 6, 8)).astype(np.float32)
             for v in era5.UPPER_VARS}
    surface = {v: r.normal(size=(6, 8)).astype(np.float32)
               for v in era5.SURFACE_VARS}
    for got, want in zip(era5.stack_state(upper, surface),
                         jax_era5.stack_state(upper, surface)):
        _equal(got, want)
    assert era5.stack_state(upper, surface)[0][1, 0, 0, 0] == upper["q"][-1, 0, 0]


def test_file_backed_dataset_matches_jax(tmp_path, route):
    root = tmp_path
    (root / "surface").mkdir()
    (root / "upper").mkdir()
    rng = np.random.default_rng(1)
    base = int((np.datetime64("2018-01-01", "s")
                - np.datetime64("1900-01-01", "s")) / np.timedelta64(1, "h"))
    for day in (1, 2, 3):
        _write_fake_nc(str(root / "upper" / f"upper_201801{day:02d}.nc"),
                       list(era5.UPPER_VARS), (MCFG.levels, MCFG.lat, MCFG.lon),
                       datetime(2018, 1, day), packed=day == 2, expver=False,
                       rng=rng)
    _write_fake_nc(str(root / "surface" / "surface_201801.nc"),
                   list(era5.SURFACE_VARS), (MCFG.lat, MCFG.lon),
                   datetime(2018, 1, 1), packed=True, expver=True, rng=rng,
                   times=[base, base + 24, base + 48])
    kw = dict(nc_path=str(root), horizon=24, test_start="20180101",
              test_end="20180103", test_freq="24h")
    ds = era5.make_dataset(DataConfig(**kw), "test", mcfg=MCFG)
    jds = jax_era5.make_dataset(JaxDataConfig(**kw), "test", mcfg=JAX_MCFG)
    assert not isinstance(ds, era5.SyntheticEra5Dataset)
    assert len(ds) == len(jds) == 2
    for i in range(2):
        _same_sample(ds[i], jds[i])


def _same_sample(got, want):
    assert got.times == want.times
    for k in ("upper", "surface", "target_upper", "target_surface"):
        _equal(getattr(got, k), getattr(want, k))


# ---------------------------------------------------------------------------
# dates, datasets, loader, statistics
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("freq", ["12h", "6h", "1h", "h", "D", "2D", "24h"])
def test_date_keys_match_pandas(freq):
    for start, end in (("20150101", "20150110"), ("20180103", "20180104"),
                       ("20191230", "20200102")):
        assert era5.date_keys(start, end, freq) == \
            jax_era5.date_keys(start, end, freq)


@pytest.mark.parametrize("freq", ["3M", "12H", "0h", "1W", "h12", ""])
def test_date_keys_refuse_other_forms(freq):
    with pytest.raises(ValueError):
        era5.date_keys("20150101", "20150103", freq)


def _data(split_kw):
    kw = dict(horizon=24, **split_kw)
    return DataConfig(**kw), JaxDataConfig(**kw)


def test_synthetic_dataset_matches_jax():
    dcfg, jcfg = _data(dict(train_start="20150101", train_end="20150110"))
    ds = era5.SyntheticEra5Dataset(dcfg, "train", mcfg=MCFG)
    jds = jax_era5.SyntheticEra5Dataset(jcfg, "train", mcfg=JAX_MCFG)
    assert len(ds.keys) == len(jds.keys) == 19 and len(ds) == len(jds) == 17
    for i in (0, 5, 16):
        _same_sample(ds[i], jds[i])
    assert ds[0].times == ("2015010100", "2015010200")
    batch, jbatch = ds[3].as_batch(), jds[3].as_batch()
    assert batch["times"] == jbatch["times"]
    _equal(batch["upper"], jbatch["upper"])


def _batches(loader):
    return list(loader.epoch(1))


@pytest.mark.parametrize("kw", [
    dict(batch_size=2, drop_last=False),                      # short last
    dict(batch_size=2, drop_last=True, shuffle=True, seed=3),
    dict(batch_size=2, drop_last=False, process_index=1, process_count=2),
    dict(batch_size=3, drop_last=False, shuffle=True, process_index=0,
         process_count=2, num_workers=1, prefetch=1),
])
def test_loader_matches_jax(kw):
    dcfg, jcfg = _data(dict(test_start="20150106", test_end="20150110"))
    ds = era5.make_dataset(dcfg, "test", MCFG, synthetic=True)
    jds = jax_era5.make_dataset(jcfg, "test", JAX_MCFG, synthetic=True)
    loader, jloader = era5.Loader(ds, **kw), jax_era5.Loader(jds, **kw)
    got, want = _batches(loader), _batches(jloader)
    assert len(got) == len(want) == len(loader) == len(jloader) > 0
    for g, w in zip(got, want):
        assert set(g) == set(w) and g["times"] == w["times"]
        for k in ("upper", "surface", "target_upper", "target_surface"):
            _equal(g[k], w[k])
    if not kw["drop_last"] and "process_index" not in kw:
        assert [len(b["times"][1]) for b in got] == [2, 2, 2, 1]


def test_loader_device_put_in_the_consumer():
    dcfg, _ = _data(dict(test_start="20150106", test_end="20150108"))
    ds = era5.make_dataset(dcfg, "test", MCFG, synthetic=True)
    threads = []

    def put(batch):
        threads.append(threading.current_thread())
        return era5.device_put_fn("cpu")(batch)

    host = _batches(era5.Loader(ds, 2, drop_last=False))
    moved = _batches(era5.Loader(ds, 2, drop_last=False, shard_fn=put))
    assert threads and all(t is threading.main_thread() for t in threads)
    for h, m in zip(host, moved):
        assert m["times"] == h["times"]
        assert isinstance(m["upper"], torch.Tensor)
        _equal(m["upper"].numpy(), h["upper"])


def test_loader_abandoned_epoch_stops_its_thread():
    dcfg, _ = _data(dict(test_start="20150101", test_end="20150115"))
    ds = era5.make_dataset(dcfg, "test", MCFG, synthetic=True)
    before = threading.active_count()
    for _ in era5.Loader(ds, 1, num_workers=2, prefetch=1).epoch(0):
        break
    for _ in range(100):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.05)
    assert threading.active_count() <= before


def test_compute_statistics_matches_jax():
    dcfg, jcfg = _data(dict(train_start="20150101", train_end="20150104"))
    ds = era5.make_dataset(dcfg, "train", MCFG, synthetic=True)
    jds = jax_era5.make_dataset(jcfg, "train", JAX_MCFG, synthetic=True)
    got = era5.compute_statistics(era5.Loader(ds, 2, drop_last=False))
    want = jax_era5.compute_statistics(jax_era5.Loader(jds, 2,
                                                       drop_last=False))
    assert set(got) == set(want)
    for k in want:
        _equal(got[k], want[k])
    on_device = era5.compute_statistics(era5.Loader(
        ds, 2, drop_last=False, shard_fn=era5.device_put_fn("cpu")))
    for k in want:
        _equal(on_device[k], want[k])
