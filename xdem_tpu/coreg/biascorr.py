"""Bias corrections (non-rigid alignment) against arbitrary variables.

Reference parity (/root/reference/xdem/coreg/biascorr.py): BiasCorr generic (:40, fit :167,
apply :261), DirectionalBias (:314, rotated-x variable + nfreq_sumsin bin_and_fit default),
TerrainBias (:449, default max_curvature pure bin with 100 bins), Deramp (:621, 2-D polynomial
of pixel coords, default order 2, subsample 5e5).
"""

from __future__ import annotations

import logging
from functools import partial
from typing import Any, Callable, Iterable, Literal

import jax
import jax.numpy as jnp
import numpy as np

from xdem_tpu.coreg.affine import _subsample_pair_values
from xdem_tpu.coreg.base import Coreg, NotImplementedCoregApply
from xdem_tpu.fit import (
    polynomial_1d,
    polynomial_2d,
    robust_nfreq_sumsin_fit,
    robust_norder_polynomial_fit,
    sumsin_1d,
)
from xdem_tpu.georef import Affine
from xdem_tpu.pointcloud import PointCloud
from xdem_tpu.raster import Raster

# Workflow registry mapping names to (model function, robust optimizer) — reference base.py:71-74
fit_workflows = {
    "norder_polynomial": {"func": polynomial_1d, "optimizer": robust_norder_polynomial_fit},
    "nfreq_sumsin": {"func": sumsin_1d, "optimizer": robust_nfreq_sumsin_fit},
}


@partial(jax.jit, static_argnames=("func", "n"))
def _eval_fit_func_device(func, x_in, params, n: int):
    """Evaluate a jnp-capable model function on device with traced parameters (static only in
    the function identity and parameter count, so XLA caches across applies)."""
    return func(x_in, *[params[i] for i in range(n)])


def _get_xy_rotated(shape: tuple[int, int], transform: Affine, along_track_angle: float):
    """Rotated coordinates: x-axis along `along_track_angle` degrees (clockwise from X axis).

    Equivalent role to geoutils' get_xy_rotated used by the reference (biascorr.py:370-373).
    """
    h, w = shape
    cgrid, rgrid = np.meshgrid(np.arange(w), np.arange(h))
    x, y = transform.xy(rgrid, cgrid)
    theta = np.deg2rad(along_track_angle)
    x0, y0 = np.min(x), np.min(y)
    xr = (x - x0) * np.cos(theta) + (y - y0) * np.sin(theta)
    yr = -(x - x0) * np.sin(theta) + (y - y0) * np.cos(theta)
    return xr, yr


class BiasCorr(Coreg):
    """N-dimensional bias correction by binning, fitting, or both (reference biascorr.py:40)."""

    _is_affine = False
    _needs_vars = True

    def __init__(
        self,
        fit_or_bin: Literal["bin_and_fit", "fit", "bin"] = "fit",
        fit_func: Callable[..., np.ndarray] | str = "norder_polynomial",
        fit_optimizer: Callable[..., Any] | None = None,
        bin_sizes: int | dict[str, Any] = 10,
        bin_statistic: Callable[[np.ndarray], Any] = np.nanmedian,
        bin_apply_method: Literal["linear", "per_bin"] = "linear",
        bias_var_names: Iterable[str] | None = None,
        subsample: float | int = 1.0,
    ):
        if fit_or_bin not in ["fit", "bin", "bin_and_fit"]:
            raise ValueError(f"Argument `fit_or_bin` must be 'bin_and_fit', 'fit' or 'bin', got {fit_or_bin}.")
        if fit_or_bin in ("fit", "bin_and_fit"):
            if not (callable(fit_func) or (isinstance(fit_func, str) and fit_func in fit_workflows)):
                raise TypeError(
                    "Argument `fit_func` must be a function (callable) or the string '{}', got {}.".format(
                        "', '".join(fit_workflows.keys()), type(fit_func)
                    )
                )
            if isinstance(fit_func, str):
                fit_optimizer = fit_workflows[fit_func]["optimizer"]
                fit_func = fit_workflows[fit_func]["func"]
        if fit_or_bin in ("bin", "bin_and_fit"):
            if not (isinstance(bin_sizes, int) or (
                isinstance(bin_sizes, dict)
                and all(isinstance(v, (int, Iterable)) for v in bin_sizes.values())
            )):
                # A dict of plain floats is neither a size nor bin edges (reference
                # biascorr.py:106-111 rejects it the same way)
                raise TypeError(
                    f"Argument `bin_sizes` must be an integer, or a dictionary of integers or iterables, "
                    f"got {type(bin_sizes)}."
                )
            if not callable(bin_statistic):
                raise TypeError(f"Argument `bin_statistic` must be a function (callable), got {type(bin_statistic)}.")
            if not isinstance(bin_apply_method, str):
                raise TypeError(
                    f"Argument `bin_apply_method` must be the string 'linear' or 'per_bin', "
                    f"got {type(bin_apply_method)}."
                )

        super().__init__()
        self._meta["inputs"]["fitorbin"] = {
            "fit_or_bin": fit_or_bin,
            "fit_func": fit_func,
            "fit_optimizer": fit_optimizer,
            "bin_sizes": bin_sizes,
            "bin_statistic": bin_statistic,
            "bin_apply_method": bin_apply_method,
            "bias_var_names": list(bias_var_names) if bias_var_names is not None else None,
            "nd": len(list(bias_var_names)) if bias_var_names is not None else None,
        }
        self._meta["inputs"]["random"]["subsample"] = subsample

    # ------------------------------------------------- core bin/fit on subsampled values

    def _bin_or_and_fit_biasvars(self, values: np.ndarray, bias_vars: dict[str, np.ndarray],
                                 p0: np.ndarray | None = None, **kwargs: Any) -> None:
        from xdem_tpu import spatialstats

        fb = self._meta["inputs"]["fitorbin"]
        fit_or_bin = fb["fit_or_bin"]
        var_names = list(bias_vars.keys())
        fb["bias_var_names"] = var_names

        df = None
        params = None
        if fit_or_bin in ("bin", "bin_and_fit"):
            bin_sizes = fb["bin_sizes"]
            if isinstance(bin_sizes, dict):
                bin_sizes = [bin_sizes[k] for k in var_names]
            df = spatialstats.nd_binning(
                values=values,
                list_var=[np.asarray(v) for v in bias_vars.values()],
                list_var_names=var_names,
                list_var_bins=bin_sizes,
                statistics=("count", fb["bin_statistic"]),
            )

        if fit_or_bin in ("fit", "bin_and_fit"):
            if fit_or_bin == "bin_and_fit":
                nd = len(var_names)
                sub = df[df["nd"] == nd]
                stat_name = fb["bin_statistic"].__name__
                xdata = [np.array([iv.mid for iv in sub[n]]) for n in var_names]
                ydata = sub[stat_name].values.astype(np.float64)
            else:
                xdata = [np.asarray(v, dtype=np.float64).ravel() for v in bias_vars.values()]
                ydata = np.asarray(values, dtype=np.float64).ravel()
            valid = np.isfinite(ydata)
            for xv in xdata:
                valid &= np.isfinite(xv)
            xfit = xdata[0][valid] if len(xdata) == 1 else tuple(xv[valid] for xv in xdata)
            yfit = ydata[valid]

            optimizer = fb["fit_optimizer"]
            if optimizer in (robust_norder_polynomial_fit, robust_nfreq_sumsin_fit):
                params, order = optimizer(xfit, yfit, random_state=self._meta["inputs"]["random"]["random_state"],
                                          **{k: v for k, v in kwargs.items() if k in ("hop_length",)})
            elif optimizer is not None:
                params, *_ = optimizer(fb["fit_func"], xfit, yfit, p0=p0)
            else:
                from xdem_tpu.fit import curve_fit_lm
                import jax.numpy as jnp

                fit_func = fb["fit_func"]
                if p0 is None:
                    # Size the initial guess from the model's signature (the reference's
                    # scipy.curve_fit does the same introspection): f(x, p1, ..., pk)
                    import inspect

                    n_par = max(len(inspect.signature(fit_func).parameters) - 1, 1)
                    p0 = [1.0] * n_par
                params = curve_fit_lm(
                    lambda x, *p: jnp.asarray(fit_func(x, *p)),
                    xfit if isinstance(xfit, tuple) else jnp.asarray(xfit),
                    jnp.asarray(yfit),
                    p0=list(p0),
                )

        self._meta["outputs"]["fitorbin"] = {"fit_params": params, "bin_dataframe": df}

    # ------------------------------------------------- fit entry points

    def _fit_rst_rst(self, ref_elev, tba_elev, inlier_mask, transform, crs, z_name="z",
                     bias_vars=None, weights=None, **kwargs):
        self._fit_biascorr(ref_elev, tba_elev, inlier_mask, transform, bias_vars=bias_vars, **kwargs)

    def _fit_rst_pts(self, ref_elev, tba_elev, inlier_mask, transform, crs, z_name="z",
                     bias_vars=None, weights=None, **kwargs):
        self._fit_biascorr(ref_elev, tba_elev, inlier_mask, transform, bias_vars=bias_vars, **kwargs)

    def _fit_biascorr(self, ref_elev, tba_elev, inlier_mask, transform, bias_vars=None, p0=None, **kwargs):
        if bias_vars is None:
            raise ValueError("At least one `bias_var` should be passed to the fitting function, got None.")
        fb = self._meta["inputs"]["fitorbin"]
        if fb["bias_var_names"] is not None and sorted(bias_vars.keys()) != sorted(fb["bias_var_names"]):
            raise ValueError(
                "The keys of `bias_vars` do not match the `bias_var_names` defined during "
                "instantiation: {}.".format(fb["bias_var_names"])
            )
        p = self._meta["inputs"]["random"]
        sub_ref, sub_tba, x, y, sub_aux = _subsample_pair_values(
            ref_elev, tba_elev, inlier_mask, transform, p["subsample"], p["random_state"],
            aux_vars={k: np.asarray(v) for k, v in bias_vars.items()},
        )
        diff = sub_ref - sub_tba
        self._bin_or_and_fit_biasvars(diff, {k: sub_aux[k] for k in bias_vars}, p0=p0, **kwargs)
        self._meta["outputs"]["random"] = {"subsample_final": len(diff)}

    # ------------------------------------------------- apply

    def _apply_func(self, elev, bias_vars=None, transform=None, crs=None, **kwargs):
        is_raster = isinstance(elev, Raster)
        if isinstance(elev, PointCloud):
            raise NotImplementedCoregApply("BiasCorr apply is implemented for rasters.")
        data = elev.data if is_raster else elev
        transform = elev.transform if is_raster else transform
        # Device fast path: fitted functional corrections (polynomial/sumsin) evaluate as a
        # jitted program with the raster resident — the host path round-trips the full array
        corr_dev = self._compute_correction_device(np.shape(data), transform, bias_vars)
        if corr_dev is not None:
            out_dev = jnp.asarray(data, jnp.float32) + corr_dev
            if is_raster:
                return elev.copy(new_array=out_dev)
            return np.asarray(out_dev, dtype=np.float64)
        arr = np.asarray(data, dtype=np.float64)
        corr = self._compute_correction(arr, transform, crs, bias_vars, **kwargs)
        out_arr = arr + corr
        if is_raster:
            return elev.copy(new_array=out_arr.astype(np.float32))
        return out_arr

    def _device_bias_vars(self, shape, transform, bias_vars) -> dict[str, Any] | None:
        """Device-resident bias variables for the apply fast path, or None for the host path.
        Subclasses that can synthesize their variable on device (pixel coords, rotated
        coords) override this."""
        if bias_vars is not None and all(isinstance(v, jnp.ndarray) for v in bias_vars.values()):
            return dict(bias_vars)
        return None

    def _compute_correction_device(self, shape, transform, bias_vars):
        """The fitted correction as a device array, or None when only the host path applies
        (bin modes, custom fit functions, host-resident bias variables)."""
        fb = self._meta["inputs"]["fitorbin"]
        if fb["fit_or_bin"] not in ("fit", "bin_and_fit") or fb["fit_func"] not in (
            polynomial_1d, polynomial_2d, sumsin_1d,
        ):
            return None
        dev_vars = self._device_bias_vars(shape, transform, bias_vars)
        if dev_vars is None:
            return None
        names = fb["bias_var_names"]
        if sorted(dev_vars.keys()) != sorted(names):
            raise ValueError(
                "The keys of `bias_vars` do not match the `bias_var_names` defined during "
                "instantiation or fitting: {}.".format(names)
            )
        vars_tuple = tuple(jnp.asarray(dev_vars[k], jnp.float32) for k in names)
        x_in = vars_tuple[0] if len(vars_tuple) == 1 else vars_tuple
        params = jnp.asarray(np.asarray(self._meta["outputs"]["fitorbin"]["fit_params"],
                                        np.float32))
        return _eval_fit_func_device(fb["fit_func"], x_in, params, int(params.shape[0])).reshape(shape)

    def _compute_correction(self, arr, transform, crs, bias_vars, **kwargs):
        from xdem_tpu import spatialstats

        fb = self._meta["inputs"]["fitorbin"]
        if bias_vars is None:
            raise ValueError("At least one `bias_var` should be passed to the `apply` function, got None.")
        if sorted(bias_vars.keys()) != sorted(fb["bias_var_names"]):
            raise ValueError(
                "The keys of `bias_vars` do not match the `bias_var_names` defined during "
                "instantiation or fitting: {}.".format(fb["bias_var_names"])
            )
        bias_vars = {k: np.asarray(v, dtype=np.float64) for k, v in bias_vars.items()}

        if fb["fit_or_bin"] in ("fit", "bin_and_fit"):
            vars_tuple = tuple(bias_vars[k] for k in fb["bias_var_names"])
            x_in = vars_tuple[0] if len(vars_tuple) == 1 else vars_tuple
            corr = np.asarray(fb["fit_func"](x_in, *self._meta["outputs"]["fitorbin"]["fit_params"]))
        else:
            if fb["bin_apply_method"] == "linear":
                interp = spatialstats.interp_nd_binning(
                    df=self._meta["outputs"]["fitorbin"]["bin_dataframe"],
                    list_var_names=fb["bias_var_names"],
                    statistic=fb["bin_statistic"],
                    min_count=kwargs.get("min_count", 0),
                )
                corr = interp(*[bias_vars[k].ravel() for k in fb["bias_var_names"]])
                corr = corr.reshape(np.shape(next(iter(bias_vars.values()))))
            else:
                corr = spatialstats.get_perbin_nd_binning(
                    df=self._meta["outputs"]["fitorbin"]["bin_dataframe"],
                    list_var=[bias_vars[k] for k in fb["bias_var_names"]],
                    list_var_names=fb["bias_var_names"],
                    statistic=fb["bin_statistic"],
                )
        return corr.reshape(arr.shape) if corr.shape != arr.shape else corr


class DirectionalBias(BiasCorr):
    """Directional bias correction along an angle, e.g. satellite track undulations
    (reference biascorr.py:314). Default: bin_and_fit with nfreq_sumsin over 100 bins."""

    _needs_vars = False

    def __init__(
        self,
        angle: float = 0,
        fit_or_bin: Literal["bin_and_fit", "fit", "bin"] = "bin_and_fit",
        fit_func: Any = "nfreq_sumsin",
        fit_optimizer: Any = None,
        bin_sizes: int | dict[str, Any] = 100,
        bin_statistic: Callable = np.nanmedian,
        bin_apply_method: Literal["linear", "per_bin"] = "linear",
        subsample: float | int = 1.0,
    ):
        super().__init__(fit_or_bin, fit_func, fit_optimizer, bin_sizes, bin_statistic,
                         bin_apply_method, ["angle"], subsample)
        self._meta["inputs"]["specific"]["angle"] = angle

    def _fit_rst_rst(self, ref_elev, tba_elev, inlier_mask, transform, crs, z_name="z",
                     bias_vars=None, weights=None, **kwargs):
        logging.info("Estimating rotated coordinates.")
        grid_side = ref_elev if not isinstance(ref_elev, PointCloud) else tba_elev
        x, _ = _get_xy_rotated(np.asarray(grid_side).shape, transform,
                               self._meta["inputs"]["specific"]["angle"])
        if "hop_length" not in kwargs:
            kwargs["hop_length"] = (transform.xres + transform.yres) / 2
        self._fit_biascorr(ref_elev, tba_elev, inlier_mask, transform, bias_vars={"angle": x}, **kwargs)

    _fit_rst_pts = _fit_rst_rst

    def _compute_correction(self, arr, transform, crs, bias_vars, **kwargs):
        x, _ = _get_xy_rotated(arr.shape, transform, self._meta["inputs"]["specific"]["angle"])
        return super()._compute_correction(arr, transform, crs, {"angle": x}, **kwargs)

    def _device_bias_vars(self, shape, transform, bias_vars):
        # The rotated along-track coordinate is affine in (row, col): fold the georeferencing
        # and rotation into f64 host coefficients, then synthesize on device from iota grids
        h, w = shape
        theta = np.deg2rad(self._meta["inputs"]["specific"]["angle"])
        # x = a*cc + b*rr + c ; y = d*cc + e*rr + f at pixel centers (cc+0.5, rr+0.5)
        t = transform
        xs = [t.xy(r, c) for r, c in ((0, 0), (0, w - 1), (h - 1, 0), (h - 1, w - 1))]
        x0 = min(p[0] for p in xs)
        y0 = min(p[1] for p in xs)
        kc = (t.a * np.cos(theta) + t.d * np.sin(theta))
        kr = (t.b * np.cos(theta) + t.e * np.sin(theta))
        k0 = ((t.a * 0.5 + t.b * 0.5 + t.c - x0) * np.cos(theta)
              + (t.d * 0.5 + t.e * 0.5 + t.f - y0) * np.sin(theta))
        cc = jnp.broadcast_to(jnp.arange(w, dtype=jnp.float32)[None, :], (h, w))
        rr = jnp.broadcast_to(jnp.arange(h, dtype=jnp.float32)[:, None], (h, w))
        return {"angle": jnp.float32(kc) * cc + jnp.float32(kr) * rr + jnp.float32(k0)}


class TerrainBias(BiasCorr):
    """Bias correction against a terrain attribute, default max_curvature
    (reference biascorr.py:449). Default: pure binning with 100 bins."""

    _needs_vars = False

    def __init__(
        self,
        terrain_attribute: str = "max_curvature",
        fit_or_bin: Literal["bin_and_fit", "fit", "bin"] = "bin",
        fit_func: Any = "norder_polynomial",
        fit_optimizer: Any = None,
        bin_sizes: int | dict[str, Any] = 100,
        bin_statistic: Callable = np.nanmedian,
        bin_apply_method: Literal["linear", "per_bin"] = "linear",
        subsample: float | int = 1.0,
    ):
        super().__init__(fit_or_bin, fit_func, fit_optimizer, bin_sizes, bin_statistic,
                         bin_apply_method, [terrain_attribute], subsample)
        self._meta["inputs"]["specific"]["terrain_attribute"] = terrain_attribute

    def _terrain_var(self, grid_arr, transform, bias_vars):
        from xdem_tpu import terrain

        attr_name = self._meta["inputs"]["specific"]["terrain_attribute"]
        if bias_vars is not None and attr_name in bias_vars:
            return np.asarray(bias_vars[attr_name])
        if attr_name == "elevation":
            return np.asarray(grid_arr)
        return np.asarray(
            terrain.get_terrain_attribute(np.asarray(grid_arr), attribute=attr_name,
                                          resolution=(transform.xres, transform.yres))
        )

    def _fit_rst_rst(self, ref_elev, tba_elev, inlier_mask, transform, crs, z_name="z",
                     bias_vars=None, weights=None, **kwargs):
        grid_side = ref_elev if not isinstance(ref_elev, PointCloud) else tba_elev
        attr = self._terrain_var(grid_side, transform, bias_vars)
        name = self._meta["inputs"]["specific"]["terrain_attribute"]
        self._fit_biascorr(ref_elev, tba_elev, inlier_mask, transform, bias_vars={name: attr}, **kwargs)

    _fit_rst_pts = _fit_rst_rst

    def _compute_correction(self, arr, transform, crs, bias_vars, **kwargs):
        name = self._meta["inputs"]["specific"]["terrain_attribute"]
        if bias_vars is None:
            bias_vars = {name: self._terrain_var(arr, transform, None)}
        return super()._compute_correction(arr, transform, crs, bias_vars, **kwargs)


class Deramp(BiasCorr):
    """2-D polynomial deramping on pixel coordinates (reference biascorr.py:621).
    Default order 2, subsample 5e5."""

    _needs_vars = False

    def __init__(
        self,
        poly_order: int = 2,
        fit_or_bin: Literal["bin_and_fit", "fit", "bin"] = "fit",
        fit_func: Callable = polynomial_2d,
        fit_optimizer: Any = None,
        bin_sizes: int | dict[str, Any] = 10,
        bin_statistic: Callable = np.nanmedian,
        bin_apply_method: Literal["linear", "per_bin"] = "linear",
        subsample: float | int = 5e5,
    ):
        super().__init__(fit_or_bin, fit_func, fit_optimizer, bin_sizes, bin_statistic,
                         bin_apply_method, ["xx", "yy"], subsample)
        self._meta["inputs"]["specific"]["poly_order"] = poly_order

    def _fit_rst_rst(self, ref_elev, tba_elev, inlier_mask, transform, crs, z_name="z",
                     bias_vars=None, weights=None, **kwargs):
        grid_side = ref_elev if not isinstance(ref_elev, PointCloud) else tba_elev
        shape = np.asarray(grid_side).shape
        p0 = np.zeros(shape=((self._meta["inputs"]["specific"]["poly_order"] + 1) ** 2))
        xx, yy = np.meshgrid(np.arange(0, shape[1]), np.arange(0, shape[0]))
        self._fit_biascorr(ref_elev, tba_elev, inlier_mask, transform,
                           bias_vars={"xx": xx, "yy": yy}, p0=p0, **kwargs)

    _fit_rst_pts = _fit_rst_rst

    def _bin_or_and_fit_biasvars(self, values, bias_vars, p0=None, **kwargs):
        # The 2-D polynomial is LINEAR in its coefficients: solve directly by least squares
        # instead of iterative optimization (one device solve, and exact).
        fb = self._meta["inputs"]["fitorbin"]
        if fb["fit_or_bin"] == "fit":
            order = self._meta["inputs"]["specific"]["poly_order"] + 1
            x = np.asarray(bias_vars["xx"], dtype=np.float64).ravel()
            y = np.asarray(bias_vars["yy"], dtype=np.float64).ravel()
            v = np.asarray(values, dtype=np.float64).ravel()
            ok = np.isfinite(v) & np.isfinite(x) & np.isfinite(y)
            # Solve in normalized coordinates for conditioning, rescale coefficients back
            sx = max(np.max(np.abs(x[ok])), 1.0)
            sy = max(np.max(np.abs(y[ok])), 1.0)
            xn = x[ok] / sx
            yn = y[ok] / sy
            cols = [(xn**i) * (yn**j) for i in range(order) for j in range(order)]
            A = np.stack(cols, axis=1)
            params_n, *_ = np.linalg.lstsq(A, v[ok], rcond=None)
            scale = np.array([sx**i * sy**j for i in range(order) for j in range(order)])
            params = params_n / scale
            self._meta["outputs"]["fitorbin"] = {"fit_params": params, "bin_dataframe": None}
        else:
            super()._bin_or_and_fit_biasvars(values, bias_vars, p0=p0, **kwargs)

    def _compute_correction(self, arr, transform, crs, bias_vars, **kwargs):
        xx, yy = np.meshgrid(np.arange(0, arr.shape[1]), np.arange(0, arr.shape[0]))
        return super()._compute_correction(arr, transform, crs, {"xx": xx, "yy": yy}, **kwargs)

    def _device_bias_vars(self, shape, transform, bias_vars):
        # Pixel coordinates synthesize on device (iota): the whole deramp apply runs with the
        # raster resident
        h, w = shape
        xx = jnp.broadcast_to(jnp.arange(w, dtype=jnp.float32)[None, :], (h, w))
        yy = jnp.broadcast_to(jnp.arange(h, dtype=jnp.float32)[:, None], (h, w))
        return {"xx": xx, "yy": yy}

