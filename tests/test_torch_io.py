"""The port's ``io`` against ``diffus_tpu.io``: NIfTI files written by one
package read by the other bit for bit, the native reader against the Python
one, the ReMIND2Reg layout, the case presets and the prefetching pipeline."""

import filecmp
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

import diffus_tpu.io as jio
import diffus_tpu_torch.io as tio
from diffus_tpu_torch.io import native as tnative
from diffus_tpu_torch.types import Volume
from torch_parity import seeded

ROOT = Path(__file__).resolve().parent.parent
AFFINE = np.array([[0.5, 0.0, 0.0, -10.0], [0.0, 0.7, 0.1, 4.0], [0.0, 0.0, 0.9, 2.5],
                   [0.0, 0.0, 0.0, 1.0]])


def _pair(path_nii: str) -> str:
    """Split a single-file NIfTI into an 'ni1' ``.hdr``/``.img`` pair."""
    with open(path_nii, "rb") as fh:
        payload = fh.read()
    hdr = bytearray(payload[:348])
    hdr[344:348] = b"ni1\x00"
    struct.pack_into("<f", hdr, 108, 0.0)       # vox_offset: 0 into the .img
    base = path_nii[:-len(".nii")]
    with open(base + ".hdr", "wb") as fh:
        fh.write(bytes(hdr))
    with open(base + ".img", "wb") as fh:
        fh.write(payload[352:])
    return base + ".hdr"


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz", ".hdr"])
@pytest.mark.parametrize("dtype", [np.float32, np.int16, np.float64])
def test_files_cross_packages_bit_for_bit(tmp_path, suffix, dtype):
    data = (seeded(1).normal(size=(7, 9, 5)) * 300).astype(dtype)
    for i, (write, read) in enumerate([(jio.save_nifti, tio.load_nifti),
                                       (tio.save_nifti, jio.load_nifti)]):
        path = str(tmp_path / f"v{i}.nii") + (".gz" if suffix == ".nii.gz" else "")
        write(path, data, AFFINE)
        if suffix == ".hdr":
            path = _pair(path)
        got, affine, spacing = read(path)
        want, j_affine, j_spacing = (jio.load_nifti if read is tio.load_nifti
                                     else tio.load_nifti)(path)
        assert got.dtype == np.float32 and got.tobytes() == want.tobytes()
        np.testing.assert_array_equal(got, data.astype(np.float32))
        assert affine.tobytes() == j_affine.tobytes() and spacing.tobytes() == j_spacing.tobytes()
        np.testing.assert_array_equal(affine, AFFINE.astype(np.float32))
    # the two writers write the same bytes
    a, b = str(tmp_path / "a.nii"), str(tmp_path / "b.nii")
    jio.save_nifti(a, data, AFFINE)
    tio.save_nifti(b, data, AFFINE)
    assert filecmp.cmp(a, b, shallow=False)


def test_load_volume_gives_the_ports_volume(tmp_path):
    data = seeded(2).normal(size=(6, 5, 4)).astype(np.float32)
    path = str(tmp_path / "v.nii.gz")
    tio.save_nifti(path, data[..., None], AFFINE)        # 4D with a singleton axis
    vol = tio.load_volume(path)
    want = jio.load_volume(path)
    assert isinstance(vol, Volume) and vol.shape == (6, 5, 4)
    np.testing.assert_array_equal(vol.data.numpy(), np.asarray(want.data))
    np.testing.assert_array_equal(vol.affine.numpy(), np.asarray(want.affine))
    np.testing.assert_array_equal(vol.spacing.numpy(), np.asarray(want.spacing))


def test_native_source_is_the_repositorys():
    assert filecmp.cmp(ROOT / "native" / "nifti_native.cpp",
                       ROOT / "diffus_tpu_torch" / "native" / "nifti_native.cpp", shallow=False)
    # built into the package's git-ignored build directory, never next to the source
    assert Path(tnative._SO_PATH).parent == ROOT / "diffus_tpu_torch" / "build"


@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
def test_native_reader_equals_python_reader(tmp_path, suffix):
    if not tnative.native_available():
        pytest.skip("no C++ toolchain: the native reader falls back to Python")
    data = (seeded(3).normal(size=(6, 7, 5)) * 100).astype(np.int16)
    path = str(tmp_path / ("n" + suffix))
    tio.save_nifti(path, data, AFFINE)
    got = tnative.load_nifti_native(path)
    want = tio.load_nifti(path)
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes()
    assert tnative.load_nifti_fast(path)[0].tobytes() == want[0].tobytes()
    tio.save_nifti(str(tmp_path / "p.nii"), data, AFFINE)
    pair = _pair(str(tmp_path / "p.nii"))
    assert tnative.load_nifti_native(pair)[0].tobytes() == tio.load_nifti(pair)[0].tobytes()
    out = str(tmp_path / ("w" + suffix))
    tnative.save_nifti_native(out, data.astype(np.float32), AFFINE)
    assert jio.load_nifti(out)[0].tobytes() == want[0].tobytes()
    paths = []
    for i in range(3):
        paths.append(str(tmp_path / f"b{i}{suffix}"))
        tio.save_nifti(paths[-1], data * i, AFFINE)
    stack, _, _ = tnative.load_nifti_batch(paths, threads=2)
    np.testing.assert_array_equal(stack, np.stack([data * i for i in range(3)]).astype(np.float32))


def test_find_remind_cases_and_datasets(tmp_path):
    rng = seeded(4)
    (tmp_path / "sub").mkdir()
    for name in ("ReMIND2Reg_0046_0000.nii.gz", "sub/ReMIND2Reg_0046_0001.nii.gz",
                 "ReMIND2Reg_0050_0002.nii.gz", "unrelated.nii.gz", "ReMIND2Reg_x_0001.nii.gz"):
        tio.save_nifti(str(tmp_path / name), rng.normal(size=(5, 5, 5)).astype(np.float32))
    cases = tio.find_remind_cases(str(tmp_path))
    want = jio.find_remind_cases(str(tmp_path))
    assert set(cases) == set(want) == {46, 50}
    for cid in cases:
        assert (cases[cid].ius_path, cases[cid].cet1_path, cases[cid].t2_path) == (
            want[cid].ius_path, want[cid].cet1_path, want[cid].t2_path)
    vol = cases[46].load("cet1")
    np.testing.assert_array_equal(vol.data.numpy(), np.asarray(want[46].load("cet1").data))
    with pytest.raises(FileNotFoundError, match="no t2"):
        cases[46].load("t2")
    ds, jds = tio.MRIDataset([cases[46].ius_path]), jio.MRIDataset([cases[46].ius_path])
    assert ds[0]["image"].tobytes() == jds[0]["image"].tobytes()
    assert ds[0]["spacing"] == jds[0]["spacing"]
    for axis in (0, 1, 2):
        sl, jsl = tio.iUSDataset(cases[46].ius_path, axis=axis), jio.iUSDataset(
            cases[46].ius_path, axis=axis)
        assert len(sl) == len(jsl) and sl[2].tobytes() == jsl[2].tobytes()


@pytest.mark.parametrize("case_id", [46, 50, 55, 63])
def test_scene_from_preset_matches_jax(case_id):
    assert tio.CASE_PRESETS == jio.CASE_PRESETS
    us = np.diag([0.5, 0.5, 0.5, 1.0])
    t1 = np.array([[1.0, 0.0, 0.0, 2.0], [0.0, 1.0, 0.0, -3.0], [0.0, 0.0, 1.0, 1.0],
                   [0.0, 0.0, 0.0, 1.0]])
    got = tio.scene_from_preset(case_id, us, t1, n_rays=16, us_slice_shape=(128, 96))
    want = jio.scene_from_preset(case_id, us, t1, n_rays=16, us_slice_shape=(128, 96))
    np.testing.assert_allclose(got.source.numpy(), np.asarray(want.source), rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(got.directions.numpy(), np.asarray(want.directions), rtol=1e-5,
                               atol=1e-6)
    assert got.geometry.num_samples == want.geometry.num_samples == 230
    assert got.geometry.n_rays == want.geometry.n_rays
    np.testing.assert_allclose(got.geometry.opening_angle, want.geometry.opening_angle,
                               rtol=1e-6)
    np.testing.assert_allclose(got.geometry.step, want.geometry.step, rtol=1e-5)
    np.testing.assert_array_equal(got.us_mask.numpy(), np.asarray(want.us_mask))
    assert (got.d1, got.d2) == (want.d1, want.d2)


def _cases(tmp_path, n=5, shape=(6, 5, 4)):
    rng = seeded(5)
    paths, vols = [], []
    for i in range(n):
        v = rng.normal(size=shape).astype(np.float32)
        paths.append(str(tmp_path / f"case{i}.nii.gz"))
        tio.save_nifti(paths[-1], v)
        vols.append(v)
    return paths, vols


def test_prefetcher_and_iterate_cases_match_jax(tmp_path):
    paths, vols = _cases(tmp_path)
    assert tio.batched(paths, 2) == jio.batched(paths, 2)
    assert tio.batched(paths, 2, drop_remainder=True) == jio.batched(paths, 2,
                                                                      drop_remainder=True)
    with tio.VolumePrefetcher(tio.batched(paths, 2), prefetch=1, device="cpu") as pf:
        got = list(pf)
    want = list(jio.iterate_cases(paths, batch_size=2))
    assert [g[0].shape[0] for g in got] == [2, 2, 1]
    for (stack, affine, spacing), (j_stack, j_affine, j_spacing) in zip(got, want):
        assert torch.is_tensor(stack) and stack.device.type == "cpu"
        np.testing.assert_array_equal(stack.numpy(), np.asarray(j_stack))
        np.testing.assert_array_equal(affine, j_affine)
        np.testing.assert_array_equal(spacing, j_spacing)
    ours = list(tio.iterate_cases(paths, batch_size=3, device="cpu"))
    np.testing.assert_array_equal(torch.cat([s for s, _, _ in ours]).numpy(), np.stack(vols))
    host = list(tio.iterate_cases(paths, batch_size=3, to_device=False))
    assert all(isinstance(s, np.ndarray) for s, _, _ in host)


def test_prefetcher_errors_close_and_device(tmp_path):
    paths, _ = _cases(tmp_path, n=4)
    bad = str(tmp_path / "bad.nii")
    with open(bad, "wb") as fh:
        fh.write(b"\x00" * 100)
    with tio.VolumePrefetcher(tio.batched(paths[:2] + [bad], 2), prefetch=1,
                              device="cpu") as pf:
        it = iter(pf)
        assert next(it)[0].shape[0] == 2
        with pytest.raises(ValueError):
            next(it)
    pf = tio.VolumePrefetcher(tio.batched(paths, 1), prefetch=1, device="cpu")
    next(iter(pf))
    pf.close()                                  # no deadlock against a full queue
    assert not pf._worker.is_alive()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tio.VolumePrefetcher(tio.batched(paths, 1))

