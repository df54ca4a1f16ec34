"""Ported reference gtest scenarios for the client layer.

Each test mirrors a scenario from /root/reference/src/client/Testing/
(FilePoint.cpp, FileText.cpp, FileNorcomQnh.cpp, ParameterFileText.cpp,
ParameterFileSimple.cpp, CalibratorAccumulate.cpp) against the same
fixture files. Fixtures are read from the reference checkout when
present; scenarios are skipped otherwise.
"""
import os
import shutil

import numpy as np
import pytest

from gridpp_tpu.client.file import (File, FileNetcdf, FileNorcomQnh,
                                    FilePoint, FileText)
from gridpp_tpu.client.options import Options
from gridpp_tpu.client.parameter_file import (ParameterFileSimple,
                                              ParameterFileText)

FIXTURES = "/root/reference/tests/files"

pytestmark = pytest.mark.skipif(
    not os.path.isdir(FIXTURES), reason="reference fixtures unavailable")


def fx(name):
    return os.path.join(FIXTURES, name)


class TestFilePoint:
    """Testing/FilePoint.cpp scenarios."""

    def test_as_input(self):
        f = FilePoint(fx("validPoint1.txt"), Options("lat=1 lon=2 elev=3"))
        field = f.get_field("air_temperature_2m")
        assert field[0, 0, 0, 0] == pytest.approx(290)
        assert field[1, 0, 0, 0] == pytest.approx(288)

    def test_as_ensemble(self):
        f = FilePoint(fx("validPoint2.txt"), Options("lat=1 lon=2 elev=3"))
        assert f.num_ens == 2
        field = f.get_field("air_temperature_2m")
        np.testing.assert_allclose(field[0, 0, 0], [290, 291])
        np.testing.assert_allclose(field[1, 0, 0], [288, 300])

    def test_valid_files(self):
        for opts in ("lat=1 lon=2 elev=3 time=67",
                     "lat=89 lon=2 elev=3 time=67",
                     "lat=-89 lon=-180 elev=3 time=67",
                     "lat=-89 lon=180 elev=-32 time=67",
                     "lat=89 lon=200 elev=3 time=67",
                     "lat=89 lon=-200 elev=3 time=67"):
            FilePoint(fx("validPoint1.txt"), Options(opts))

    def test_invalid(self):
        for opts in ("lon=2 elev=3 time=67",      # missing lat
                     "lat=1 elev=3 time=67",      # missing lon
                     "lat=1 lon=2 time=67",       # missing elev
                     "lat=91 lon=2 elev=3 time=67",
                     "lat=-91 lon=2 elev=3 time=67"):
            with pytest.raises(RuntimeError):
                FilePoint(fx("validPoint1.txt"), Options(opts))
        with pytest.raises(RuntimeError):  # missing time for missing file
            FilePoint(fx("hd92h3d98h38.txt"), Options("lat=1 lon=2 elev=3"))

    def test_as_output_roundtrip(self, tmp_path):
        """FilePoint.cpp asOutput: nearest-downscale 10x10.nc to a point
        file, write, re-read; expects 303 at time 0."""
        from gridpp_tpu.client.schemes import DownscalerNearestNeighbour
        src = FileNetcdf(fx("10x10.nc"))
        out_path = str(tmp_path / "filePoint.txt")
        dst = FilePoint(out_path,
                        Options("lat=1 lon=2 elev=3 time=2 ens=1"))
        d = DownscalerNearestNeighbour("air_temperature_2m", Options())
        d.downscale(src, dst)
        dst.write(["air_temperature_2m"])
        again = FilePoint(out_path, Options("lat=1 lon=2 elev=3 time=2"))
        field = again.get_field("air_temperature_2m")
        assert field[0, 0, 0, 0] == pytest.approx(303)


class TestFileText:
    """Testing/FileText.cpp scenarios."""

    def test_as_input(self):
        f = FileText(fx("validText1.txt"))
        field = f.get_field("air_temperature_2m")
        assert field[0, 0, 0, 0] == pytest.approx(3.2)
        assert field[1, 0, 0, 0] == pytest.approx(4.1)

    def test_as_ensemble(self):
        f = FileText(fx("validText2.txt"))
        field = f.get_field("air_temperature_2m")
        assert f.num_ens == 3
        assert field.shape[1] == 2  # two locations, sorted by (lat, lon)
        np.testing.assert_allclose(field[0, 0, 0], [11, 21, -1])
        np.testing.assert_allclose(field[0, 1, 0], [3.2, 1.5, 5.1])
        assert np.isnan(field[1, 0, 0]).all()  # (60,8) missing at time 1
        np.testing.assert_allclose(field[1, 1, 0], [4, 1, 2])

    def test_invalid(self):
        with pytest.raises(RuntimeError):
            FileText(fx("invalidText1.txt"))


class TestFileNorcomQnh:
    """Testing/FileNorcomQnh.cpp scenarios."""

    OPTS = ("lats=1,2 lons=2,3 elevs=100,120 names=point1,point2 "
            "numTimes=2 startTime=0 endTime=1")

    def test_options(self, tmp_path):
        f = FileNorcomQnh(str(tmp_path / "test.txt"), Options(self.OPTS))
        np.testing.assert_allclose(f.grid.lats[0], [1, 2])
        np.testing.assert_allclose(f.grid.lons[0], [2, 3])
        np.testing.assert_allclose(f.grid.elevs[0], [100, 120])

    def test_valid(self, tmp_path):
        FileNorcomQnh(str(tmp_path / "t.txt"),
                      Options("lats=1 lons=300 elevs=3 numTimes=2 "
                              "startTime=0 endTime=1 names=test"))

    def test_invalid(self, tmp_path):
        p = str(tmp_path / "t.txt")
        for opts in (
                "lats=1,2 lons=2 elevs=3 names=test numTimes=2 "
                "startTime=0 endTime=1",
                "lats=2 lons=2,3,2 elevs=3 names=test numTimes=2 "
                "startTime=0 endTime=1",
                "lats=2 lons=2 elevs=3,2 names=test numTimes=2 "
                "startTime=0 endTime=1",
                "lats=1 lons=2 elevs=3 names=q,w numTimes=2 "
                "startTime=0 endTime=1",
                "lats=91 lons=2 elevs=3 names=q numTimes=2 "
                "startTime=0 endTime=1",
                "lats=1 lons=2 elevs=3 names=q numTimes=2 "
                "startTime=1 endTime=0"):
            with pytest.raises(RuntimeError):
                FileNorcomQnh(p, Options(opts))

    def test_write_bulletin(self, tmp_path):
        p = str(tmp_path / "qnh.txt")
        f = FileNorcomQnh(p, Options(self.OPTS))
        field = np.zeros((2, 1, 2, 1), np.float32)
        field[:, 0, 0, 0] = [101325, 100925]  # min 100925 -> 1009 hPa
        field[:, 0, 1, 0] = [99000, 99500]    # min 99000 -> 0990 hPa
        f.add_field("surface_air_pressure", field)
        f.write(["surface_air_pressure"])
        text = open(p).read()
        assert text.startswith("FBNO52 ENNC ")
        assert "EST MIN QNH point1: 1009 HPA" in text
        assert "EST MIN QNH point2: 0990 HPA" in text


class TestParameterFileText:
    """Testing/ParameterFileText.cpp scenarios."""

    def test_single_time(self):
        f = ParameterFileText(fx("parametersSingleTime.txt"))
        par = f.parameters_at_time(0)
        assert par.size == 9
        assert par[0] == pytest.approx(-1.2021)
        assert par[8] == pytest.approx(0.0007985)
        # any time resolves to the single row
        np.testing.assert_array_equal(f.parameters_at_time(10), par)

    def test_multiple_time(self):
        f = ParameterFileText(fx("parametersMultipleTime.txt"))
        assert len(np.unique(f._times)) == 8
        par = f.parameters_at_time(30)
        assert par.size == 8
        assert par[0] == pytest.approx(0.04198875)
        assert par[5] == pytest.approx(-0.04039751)

    def test_spatial(self):
        f = ParameterFileText(fx("parametersKriging.txt"))
        assert f.is_location_dependent()


class TestParameterFileSimple:
    """Testing/ParameterFileSimple.cpp scenario."""

    def test_basics(self):
        f = ParameterFileSimple([1.0, 2.0, 3.0])
        assert not f.is_location_dependent()
        assert f.get_times() == [0]
        np.testing.assert_allclose(f.parameters_at_time(0), [1, 2, 3])
        rows = f.params_for_locations(0, [60, 61], [10, 11])
        assert rows.shape == (2, 3)
        np.testing.assert_allclose(rows[1], [1, 2, 3])


class TestCalibratorOiFixture:
    """Operational OI calibrator against a spatial parameter fixture
    (the reference exercises CalibratorOi through the 10x10/parameter
    text fixtures)."""

    def test_oi_with_parameter_fixture(self):
        from gridpp_tpu.client.parameter_file import get_parameter_file
        from gridpp_tpu.client.schemes import CalibratorOi
        f = FileNetcdf(fx("10x10.nc"))
        name = "air_temperature_2m"
        before = f.get_field(name).copy()
        par = get_parameter_file(fx("parametersKriging.txt"))
        assert par.is_location_dependent()
        cal = CalibratorOi(name, Options("d=200000 maxLocations=10"))
        cal.calibrate(f, par)
        after = f.get_field(name)
        assert after.shape == before.shape
        assert np.isfinite(after).sum() >= np.isfinite(before).sum() - 1
        # the analysis must move toward the (much colder) point
        # "observations" of the fixture
        assert np.nanmean(after) < np.nanmean(before)
        assert not np.array_equal(after, before)

    def test_cli_end_to_end_oi(self, tmp_path):
        """Full CLI run: NetCDF in -> nearest downscale -> OI calibrate
        -> NetCDF out (Driver/Gridpp.cpp pipeline shape)."""
        import shutil as _shutil
        from gridpp_tpu.client import main
        src = str(tmp_path / "in.nc")
        dst = str(tmp_path / "out.nc")
        _shutil.copy(fx("10x10.nc"), src)
        _shutil.copy(fx("10x10.nc"), dst)
        rc = main([src, dst, "-v", "air_temperature_2m",
                   "-d", "nearest",
                   "-c", "oi", "d=200000",
                   "-p", fx("parametersKriging.txt")])
        assert rc == 0
        out = FileNetcdf(dst)
        after = out.get_field("air_temperature_2m")
        ref = FileNetcdf(fx("10x10.nc")).get_field("air_temperature_2m")
        assert not np.array_equal(after, ref)


class TestCalibratorAccumulateFixture:
    """Testing/CalibratorAccumulate.cpp:26-53 golden values."""

    def test_accumulate_1x1(self):
        from gridpp_tpu.client.schemes import CalibratorAccumulate
        f = FileNetcdf(fx("1x1.nc"))
        name = "air_temperature_2m"
        cal = CalibratorAccumulate(name, Options())
        cal.calibrate(f, None)
        after = f.get_field(name)
        expected = [0, 20, 35, 56, 70, 100, 121, 140]
        for t, v in enumerate(expected):
            assert after[t, 0, 0, 0] == pytest.approx(v), t
        assert np.isnan(after[8, 0, 0, 0])
        assert np.isnan(after[9, 0, 0, 0])

    def test_accumulate_10x10(self):
        from gridpp_tpu.client.schemes import CalibratorAccumulate
        f = FileNetcdf(fx("10x10.nc"))
        name = "precipitation_amount"
        cal = CalibratorAccumulate(name, Options())
        cal.calibrate(f, None)
        after = f.get_field(name)
        assert after[0, 5, 2, 0] == pytest.approx(0)
        assert after[1, 5, 2, 0] == pytest.approx(0.539526, rel=1e-5)
        assert after[0, 5, 9, 0] == pytest.approx(0)
        assert after[1, 5, 9, 0] == pytest.approx(6.929162, rel=1e-5)
        assert after[0, 0, 9, 0] == pytest.approx(0)
        assert after[1, 0, 9, 0] == pytest.approx(5.442121, rel=1e-5)


class TestCalibratorQcFixture:
    """Testing/CalibratorQc.cpp:21-79 golden values on 10x10.nc."""

    def _run(self, opts):
        from gridpp_tpu.client.schemes import CalibratorQc
        f = FileNetcdf(fx("10x10.nc"))
        name = "air_temperature_2m"
        CalibratorQc(name, Options(opts)).calibrate(f)
        return f.get_field(name)

    def test_min_max(self):
        after = self._run("min=304 max=305.8")
        assert after[0, 5, 2, 0] == pytest.approx(304)      # was 301
        assert after[0, 5, 9, 0] == pytest.approx(304)      # was 304
        assert after[0, 0, 9, 0] == pytest.approx(305.8)    # was 320

    def test_nomax(self):
        after = self._run("max=307")
        assert after[0, 5, 2, 0] == pytest.approx(301)
        assert after[0, 5, 9, 0] == pytest.approx(304)
        assert after[0, 0, 9, 0] == pytest.approx(307)

    def test_nomin(self):
        after = self._run("min=303")
        assert after[0, 5, 2, 0] == pytest.approx(303)
        assert after[0, 5, 9, 0] == pytest.approx(304)
        assert after[0, 0, 9, 0] == pytest.approx(320)

    def test_missing_value(self):
        from gridpp_tpu.client.schemes import CalibratorQc
        f = FileNetcdf(fx("10x10.nc"))
        name = "air_temperature_2m"
        field = f.get_field(name)
        field[0, 5, 2, 0] = np.nan
        field[0, 5, 9, 0] = np.nan
        field[0, 0, 9, 0] = np.nan
        f.add_field(name, field)
        CalibratorQc(name, Options("min=303 max=307")).calibrate(f)
        after = f.get_field(name)
        assert np.isnan(after[0, 5, 2, 0])
        assert np.isnan(after[0, 5, 9, 0])
        assert np.isnan(after[0, 0, 9, 0])


class TestCalibratorQnhFixture:
    """Testing/CalibratorQnh.cpp golden values."""

    def test_10x10(self):
        from gridpp_tpu.client.schemes import CalibratorQnh
        f = FileNetcdf(fx("10x10.nc"))
        p = f.get_field("surface_air_pressure")
        assert p[0, 5, 2, 0] == pytest.approx(98334.44, rel=1e-6)
        CalibratorQnh("qnh", Options()).calibrate(f)
        qnh = f.get_field("qnh")
        assert qnh.shape[1:] == (10, 10, 1)
        # Altitude 159.6324, pressure 98334.44 (CalibratorQnh.cpp:36)
        assert qnh[0, 5, 2, 0] == pytest.approx(100220.6455, rel=1e-6)

    def test_calc_qnh(self):
        import gridpp_tpu as gridpp
        assert gridpp.qnh([100000], [0])[0] == pytest.approx(100000)
        assert gridpp.qnh([0], [0])[0] == pytest.approx(0)
        assert gridpp.qnh([99000], [100])[0] == pytest.approx(
            100184.6424, rel=1e-6)
        assert gridpp.qnh([99000], [-100])[0] == pytest.approx(
            97826.7259, rel=1e-6)
        assert gridpp.qnh([0], [-100])[0] == pytest.approx(0)


class TestCalibratorNeighbourhoodFixture:
    """Testing/CalibratorNeighbourhood.cpp:21-47 golden values."""

    def test_10x10_radius1_then_2(self):
        from gridpp_tpu.client.schemes import CalibratorNeighbourhood
        f = FileNetcdf(fx("10x10.nc"))
        name = "air_temperature_2m"
        CalibratorNeighbourhood(name, Options("radius=1")).calibrate(f)
        after = f.get_field(name)
        assert after.shape[1:] == (10, 10, 1)
        golden = {(5, 2): 304.6667, (5, 9): 306.1667, (9, 9): 303,
                  (0, 9): 308.25, (0, 0): 302, (1, 0): 303,
                  (5, 0): 304.6667, (9, 0): 306.25, (8, 0): 305.5,
                  (8, 1): 300 + 61.0 / 9}
        for (y, x), v in golden.items():
            assert after[0, y, x, 0] == pytest.approx(v, rel=1e-6), (y, x)
        CalibratorNeighbourhood(name, Options("radius=2")).calibrate(f)
        after = f.get_field(name)
        assert after[0, 5, 2, 0] == pytest.approx(304.73114, rel=1e-6)
        assert after[0, 5, 9, 0] == pytest.approx(305.355, abs=1e-3)


class TestCalibratorDeaccumulateFixture:
    """Testing/CalibratorDeaccumulate.cpp golden values on 1x1.nc."""

    def test_1x1_window3(self):
        from gridpp_tpu.client.schemes import CalibratorDeaccumulate
        f = FileNetcdf(fx("1x1.nc"))
        name = "precipitation_amount_acc"
        CalibratorDeaccumulate(name, Options("window=3")).calibrate(f)
        after = f.get_field(name)
        expected = [np.nan, np.nan, np.nan, 4, 2.5, 6, np.nan, 6.5, 2,
                    np.nan]
        for t, v in enumerate(expected):
            got = after[t, 0, 0, 0]
            if np.isnan(v):
                assert np.isnan(got), t
            else:
                assert got == pytest.approx(v), t

    def test_1x1_window0(self):
        # window=0: acc[t] - acc[t-0] = 0 (NaN where the field is missing)
        from gridpp_tpu.client.schemes import CalibratorDeaccumulate
        f = FileNetcdf(fx("1x1.nc"))
        name = "air_temperature_2m"
        before = f.get_field(name).copy()
        CalibratorDeaccumulate(name, Options("window=0")).calibrate(f)
        after = f.get_field(name)
        assert after.shape == before.shape
        finite = np.isfinite(before)
        assert (after[finite] == 0).all()
        assert np.isnan(after[~finite]).all()

    def test_1x1_default(self):
        from gridpp_tpu.client.schemes import CalibratorDeaccumulate
        f = FileNetcdf(fx("1x1.nc"))
        name = "air_temperature_2m"
        CalibratorDeaccumulate(name, Options()).calibrate(f)
        after = f.get_field(name)
        expected = [np.nan, -3, -5, 6, -7, 16, -9, -2, np.nan, np.nan]
        for t, v in enumerate(expected):
            got = after[t, 0, 0, 0]
            if np.isnan(v):
                assert np.isnan(got), t
            else:
                assert got == pytest.approx(v), t


class TestCalibratorThresholdFixture:
    """Testing/CalibratorThreshold.cpp golden values on 1x1.nc."""

    def test_1x1(self):
        from gridpp_tpu.client.schemes import CalibratorThreshold
        f = FileNetcdf(fx("1x1.nc"))
        name = "air_temperature_2m"
        CalibratorThreshold(name, Options(
            "thresholds=20 values=0,2")).calibrate(f)
        after = f.get_field(name)
        expected = [2, 2, 0, 2, 0, 2, 2, 0, np.nan, 2]
        for t, v in enumerate(expected):
            got = after[t, 0, 0, 0]
            if np.isnan(v):
                assert np.isnan(got), t
            else:
                assert got == pytest.approx(v), t

    def test_1x1_equals(self):
        from gridpp_tpu.client.schemes import CalibratorThreshold
        f = FileNetcdf(fx("1x1.nc"))
        name = "precipitation_amount_acc"
        CalibratorThreshold(name, Options(
            "thresholds=3,3.5,4 values=-5,11,0,2 equals=0,1,0")).calibrate(f)
        after = f.get_field(name)
        assert after[0, 0, 0, 0] == pytest.approx(-5)   # 0
        assert after[1, 0, 0, 0] == pytest.approx(11)   # 3
        assert after[2, 0, 0, 0] == pytest.approx(2)    # 4
        assert after[4, 0, 0, 0] == pytest.approx(2)    # 5.5
        assert np.isnan(after[6, 0, 0, 0])              # MV
        assert after[7, 0, 0, 0] == pytest.approx(2)    # 12

    def test_1x1_equals_upper(self):
        from gridpp_tpu.client.schemes import CalibratorThreshold
        f = FileNetcdf(fx("1x1.nc"))
        name = "precipitation_amount_acc"
        CalibratorThreshold(name, Options(
            "thresholds=3,3.5,10 values=-5,11,0,2 equals=1,0,1")).calibrate(f)
        after = f.get_field(name)
        assert after[1, 0, 0, 0] == pytest.approx(-5)   # 3
        assert after[5, 0, 0, 0] == pytest.approx(0)    # 10
        assert after[7, 0, 0, 0] == pytest.approx(2)    # 12


class TestCalibratorRegressionFixture:
    """Testing/CalibratorRegression.cpp golden values on 10x10.nc."""

    def _run(self, parfile):
        from gridpp_tpu.client.schemes import CalibratorRegression
        f = FileNetcdf(fx("10x10.nc"))
        name = "air_temperature_2m"
        par = ParameterFileText(fx(parfile))
        CalibratorRegression(name, Options()).calibrate(f, par)
        return f.get_field(name)

    def test_0order(self):
        after = self._run("regression0order.txt")
        for y, x in ((5, 2), (5, 9), (0, 9)):
            assert after[0, y, x, 0] == pytest.approx(0.3), (y, x)

    def test_1order(self):
        after = self._run("regression1order.txt")
        assert after[0, 5, 2, 0] == pytest.approx(361.5)  # 0.3 + 1.2*301
        assert after[0, 5, 9, 0] == pytest.approx(365.1)
        assert after[0, 0, 9, 0] == pytest.approx(384.3)

    def test_2order(self):
        after = self._run("regression2order.txt")
        # -0.3 + 1.02*301 - 0.8*301^2
        assert after[0, 5, 2, 0] == pytest.approx(-72174.08, rel=1e-6)
        assert after[0, 5, 9, 0] == pytest.approx(-73623.02, rel=1e-6)
        assert after[0, 0, 9, 0] == pytest.approx(-81593.90, rel=1e-6)

    def test_missing_parameters(self):
        after = self._run("regressionMissing.txt")
        for y, x in ((5, 2), (5, 9), (0, 9)):
            assert np.isnan(after[0, y, x, 0]), (y, x)

    def test_invalid_no_coefficients(self):
        """EXPECT_DEATH in the reference -> raises here
        (Testing/CalibratorRegression.cpp invalid/invalid2)."""
        from gridpp_tpu.client.schemes import CalibratorRegression
        f = FileNetcdf(fx("10x10.nc"))
        name = "air_temperature_2m"
        par = ParameterFileText(fx("regressionInvalid1.txt"))
        with pytest.raises((RuntimeError, ValueError, IndexError)):
            CalibratorRegression(name, Options()).calibrate(f, par)


class TestCalibratorMaskFixture:
    """Testing/CalibratorMask.cpp golden values: two parameter points
    (3,5) r=223km and (4,6) r=336km on the 10x10 degree grid."""

    def test_mask_out(self):
        from gridpp_tpu.client.schemes import CalibratorMask
        f = FileNetcdf(fx("10x10.nc"))
        name = "air_temperature_2m"
        par = ParameterFileText(fx("mask0.txt"))
        CalibratorMask(name, Options("keep=0")).calibrate(f, par)
        after = f.get_field(name)
        assert after[0, 5, 2, 0] == pytest.approx(301)
        assert np.isnan(after[0, 3, 5, 0])
        assert np.isnan(after[0, 3, 3, 0])
        assert np.isnan(after[0, 2, 5, 0])
        assert np.isnan(after[0, 4, 9, 0])
        assert after[0, 2, 3, 0] == pytest.approx(302)
        assert after[0, 6, 9, 0] == pytest.approx(310)

    def test_mask_in(self):
        from gridpp_tpu.client.schemes import CalibratorMask
        f = FileNetcdf(fx("10x10.nc"))
        name = "air_temperature_2m"
        par = ParameterFileText(fx("mask0.txt"))
        CalibratorMask(name, Options()).calibrate(f, par)  # keep=1 default
        after = f.get_field(name)
        assert np.isnan(after[0, 5, 2, 0])
        assert after[0, 3, 5, 0] == pytest.approx(302)
        assert after[0, 3, 3, 0] == pytest.approx(302)
        assert after[0, 2, 5, 0] == pytest.approx(302)
        assert after[0, 4, 9, 0] == pytest.approx(302)
        assert np.isnan(after[0, 2, 3, 0])
        assert np.isnan(after[0, 6, 9, 0])


class TestCalibratorSortFake:
    """Testing/CalibratorSort.cpp ensemble sorting incl. MV placement."""

    @pytest.mark.parametrize("before,after", [
        ([3, 1, 2], [1, 2, 3]),
        ([1, 1, 2], [1, 1, 2]),
        ([3, 1, 1], [1, 1, 3]),
        ([3, np.nan, 2], [2, 3, np.nan]),
        ([2, np.nan, 2], [2, 2, np.nan]),
        ([np.nan, np.nan, np.nan], [np.nan, np.nan, np.nan]),
        ([np.nan, 1, np.nan], [1, np.nan, np.nan]),
    ])
    def test_simple(self, before, after):
        from gridpp_tpu.client.file import FileFake
        from gridpp_tpu.client.schemes import CalibratorSort
        f = FileFake(1, 1, 1, 3)
        name = "air_temperature_2m"
        f.add_field(name, np.asarray(before, np.float32).reshape(1, 1, 1, 3))
        CalibratorSort(name, Options()).calibrate(f)
        got = f.get_field(name)[0, 0, 0]
        np.testing.assert_array_equal(np.isnan(got), np.isnan(after))
        finite = ~np.isnan(np.asarray(after))
        np.testing.assert_allclose(got[finite], np.asarray(after)[finite])


class TestKDTreeScenarios:
    """Testing/KDTree.cpp nearest-neighbour scenarios, ported to the
    library Grid (the client's legacy KDTree is subsumed by it)."""

    def _grid(self, lats, lons):
        import gridpp_tpu as gridpp
        return gridpp.Grid(np.asarray(lats, float),
                           np.asarray(lons, float))

    def test_single(self):
        g = self._grid([[3.0]], [[2.0]])
        assert tuple(g.get_nearest_neighbour(3, 2)) == (0, 0)
        assert tuple(g.get_nearest_neighbour(2, 1)) == (0, 0)

    def test_1row(self):
        g = self._grid([[3, 2, 0, 2]], [[3, 0, 0, 2]])
        assert tuple(g.get_nearest_neighbour(3, 3)) == (0, 0)
        assert tuple(g.get_nearest_neighbour(0.5, 0.9)) == (0, 2)
        i, j = g.get_nearest_neighbour(2.1, -0.1)
        assert i == 0 and j in (1, 3)

    def test_matrix(self):
        lats = [[0, 0, 0, 0], [1, 1, 1, 1]]
        lons = [[0, 1, 2, 3], [0, 1, 2, 3]]
        g = self._grid(lats, lons)
        assert tuple(g.get_nearest_neighbour(0, 0)) == (0, 0)
        assert tuple(g.get_nearest_neighbour(1.1, 0.6)) == (1, 1)
        assert tuple(g.get_nearest_neighbour(0.2, 2.4)) == (0, 2)
        assert tuple(g.get_nearest_neighbour(10, 10)) == (1, 3)
        assert tuple(g.get_nearest_neighbour(-10, 10)) == (0, 3)

    def test_cross(self):
        # irregular 1x5 row: reference KDTree.cpp:96-121 (note the
        # reference's own fixture bug lat[4]/lon[3]; reproduced)
        lats = [[0, 1, 1, 1, 2]]
        lons = [[1, 0, 1, 1, 0]]
        g = self._grid(lats, lons)
        assert tuple(g.get_nearest_neighbour(0.1, 1)) == (0, 0)
        assert tuple(g.get_nearest_neighbour(0.6, 1)) == (0, 2)
        assert tuple(g.get_nearest_neighbour(1, 0.1)) == (0, 1)
