"""Reference-compatible ``Wavelets`` class on PyTorch (the port of
``pypwt_tpu.api``).

Mirrors the Cython class (src/pypwt.pyx:64-615) and the C++ plan object
(pdwt/src/wt.cu:84-305): the constructor puts the image on ``device``,
``forward()``/``inverse()`` run the level loops of ``core.dwt``,
``core.haar``, ``core.swt`` and ``core.nonsep`` (on a CUDA device through
the level kernels: K1/K2 for the 2D DWT, K8/K9 for the 2D SWT, K3/K4 for
the 1D DWT, K10 for the 1D SWT, K16/K17 and K18a/K18b for the
non-separable DWT and SWT of a custom 2D bank; under
``core.dwt.set_kernels("mxu")`` the tensor-core forms K5/K6, K7a/K7b,
K11a/K11b and K12a/K12b for the levels they cover; with tail fusion on,
``core.dwt.set_tail_fuse(True)``, the 2D DWT's levels 2..L in one launch of
K24/K25), coefficients live on the
device and are copied back on access, and the reference's state machine
(coefficients are declared invalid after ``inverse()``) is kept.

Every plan is ported and runs on the card: 2D, batched 1D (``ndim=1``) and
one signal, DWT or SWT, separable or not (``do_separable=0``, 2D only),
with any of the 72 banks, a custom separable bank or a custom 2D bank;
thresholds, norms, ``add_wavelet`` and cycle spinning.  The denoising
pipelines are in ``pipeline``.
"""

from __future__ import annotations

import numpy as np
import torch

from .filters import FilterBank, MAX_FILTER_WIDTH, get_filter_bank
from .core import dwt, haar, nonsep, swt, thresh
from .core.shapes import clamp_levels, div2, level_shapes_1d, level_shapes_2d
from .version import __version__

# state machine (wt.h:8-17)
W_INIT = "INIT"
W_FORWARD = "FORWARD"
W_INVERSE = "INVERSE"

_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.float64): torch.float64}


class Wavelets:
    """Wavelet transform plan bound to one image geometry.

    img: 2D or 1D array (numpy array or tensor; float32 coerced, like
    pypwt.pyx:224-235)
    wname: wavelet name (72 built-ins)
    levels: decomposition levels (clamped like wt.cu:155-165)
    do_separable / do_cycle_spinning / do_swt: mode flags (a 1D transform
    is always separable, wt.cu:138-142)
    ndim: pass ndim=1 with a 2D image for a batched-1D transform of its rows
    seed: seed of the numpy generator that draws cycle-spinning shifts
    device: torch device of the image and coefficients ("cuda" runs the
    CUDA level kernels, "cpu" the plain torch path)
    """

    def __init__(self, img, wname, levels, do_separable=1,
                 do_cycle_spinning=0, do_swt=0, ndim=2, seed=None,
                 dtype=np.float32, device="cuda"):
        self.dtype = np.dtype(dtype)
        if self.dtype not in _DTYPES:
            raise ValueError("dtype must be float32 or float64")
        self.device = torch.device(device)
        img = self._checkarray(img)
        ndim = min(int(ndim), 2)

        self.batched1d = 0
        if img.ndim == 2:
            self.Nr, self.Nc = img.shape
            self.batched1d = int(ndim == 1)
        elif img.ndim == 1:
            self.Nr, self.Nc = 1, img.shape[0]
        else:
            raise NotImplementedError(
                "Wavelets(): Only 1D and 2D transforms are supported for now")
        self.shape = tuple(img.shape)
        self.ndim = 2 if self.batched1d else img.ndim
        self._eff_ndim = 1 if (self.batched1d or img.ndim == 1) else 2

        if self._eff_ndim == 1:
            do_separable = 1  # wt.cu:138-142

        self.wname = wname
        self.do_separable = int(bool(do_separable))
        self.do_cycle_spinning = int(bool(do_cycle_spinning))
        self.do_swt = int(bool(do_swt))

        self._fb = get_filter_bank(wname)
        # the non-separable plan's 2D bank (pypwt_tpu/api.py:180-182)
        self._f2d = (None if self.do_separable
                     else nonsep.Filters2D.from_bank(self._fb))
        self.hlen = self._fb.hlen
        self.levels = clamp_levels(int(levels), (self.Nr, self.Nc),
                                   self._fb.hlen, self._eff_ndim)
        if self.do_cycle_spinning and self.do_swt:
            print("Warning: makes little sense to use Cycle spinning with "
                  "stationary Wavelet transform")
        if self.do_cycle_spinning and self.ndim == 1:
            raise ValueError(
                "cycle spinning is not implemented for 1D. Use SWT instead.")
        self.sizes = self._compute_sizes()
        self._rng = np.random.default_rng(seed)
        self.current_shift = (0, 0)
        self._state = W_INIT

        self._image = img
        self._coeffs = self._zero_coeffs()

    # ------------------------------------------------------------------
    # plumbing
    # ------------------------------------------------------------------

    def _checkarray(self, arr, shp=None):
        """``arr`` as a contiguous tensor of this plan's dtype on its
        device, with the shape checks of pypwt.pyx:224-235."""
        if isinstance(arr, torch.Tensor):
            res = arr.detach()
        else:
            res = torch.from_numpy(np.ascontiguousarray(arr, dtype=self.dtype))
        res = res.to(device=self.device, dtype=_DTYPES[self.dtype])
        res = res.contiguous()
        if shp is not None:
            if res.ndim != len(shp):
                raise ValueError(
                    "Invalid number of dimensions (expected %d, got %d)"
                    % (len(shp), res.ndim))
            if tuple(res.shape) != tuple(shp):
                raise ValueError(
                    "The image does not have the correct shape "
                    "(expected %s, got %s)" % (str(tuple(shp)),
                                               str(tuple(res.shape))))
        return res

    @staticmethod
    def div2(n):
        return div2(n)

    def _compute_sizes(self):
        """Per-level detail shapes, level 1 first (pypwt.pyx:247-258); a 1D
        level is (Nr, n), with Nr = 1 for one signal."""
        if self._eff_ndim == 2:
            return level_shapes_2d(self.Nr, self.Nc, self.levels, self.do_swt)
        return [(self.Nr, n) for n in
                level_shapes_1d(self.Nc, self.levels, self.do_swt)]

    def _coeff_shape(self, i):
        """Shape of the level-(i+1) details; one signal's are (n,)."""
        return self.sizes[i][1:] if self.ndim == 1 else self.sizes[i]

    def _zero_coeffs(self):
        def z(shape):
            return torch.zeros(shape, dtype=_DTYPES[self.dtype],
                               device=self.device)
        out = [z(self._coeff_shape(self.levels - 1))]
        for i in range(self.levels):
            s = self._coeff_shape(i)
            out.append(z(s) if self._eff_ndim == 1
                       else tuple(z(s) for _ in range(3)))
        return out

    def _use_haar(self):
        # the butterfly serves the decimated transform only
        # (pypwt_tpu/api.py:58, wt.cu:248, :255); a haar SWT runs the
        # a-trous levels; a custom 2D bank (no 1D bank) never takes it
        return (self._fb is not None and self._fb.hlen == 2
                and not self.do_swt)

    def _forward_pyramid(self, x):
        fb, levels = self._fb, self.levels
        if self._eff_ndim == 1:
            if self._use_haar():
                return haar.haar_wavedec1(x, levels)
            if self.do_swt:
                return swt.swt1d(x, fb, levels)
            return dwt.wavedec1(x, fb, levels)
        if self._use_haar():
            return haar.haar_wavedec2(x, levels)
        if not self.do_separable:
            if self.do_swt:
                return nonsep.ns_swt2d(x, self._f2d, levels)
            return nonsep.ns_wavedec2(x, self._f2d, levels)
        if self.do_swt:
            return swt.swt2d(x, fb, levels)
        return dwt.wavedec2(x, fb, levels)

    def _inverse_pyramid(self, coeffs):
        fb = self._fb
        if self._eff_ndim == 1:
            if self._use_haar():
                return haar.haar_waverec1(coeffs, self.Nc)
            if self.do_swt:
                return swt.iswt1d(coeffs, fb)
            return dwt.waverec1(coeffs, fb, self.Nc)
        if self._use_haar():
            return haar.haar_waverec2(coeffs, self.shape)
        if not self.do_separable:
            if self.do_swt:
                return nonsep.ins_swt2d(coeffs, self._f2d)
            return nonsep.ns_waverec2(coeffs, self._f2d, self.shape)
        if self.do_swt:
            return swt.iswt2d(coeffs, fb)
        return dwt.waverec2(coeffs, fb, self.shape)

    # ------------------------------------------------------------------
    # transforms
    # ------------------------------------------------------------------

    def forward(self, img=None):
        """Forward transform (pypwt.pyx:333-344 / wt.cu:236-269)."""
        if img is not None:
            self._image = self._checkarray(img, self.shape)
        if self.do_cycle_spinning:
            sr = int(self._rng.integers(0, self.Nr))
            sc = int(self._rng.integers(0, self.Nc))
            self.current_shift = (sr, sc)
            self._image = self._circshift_image(self._image, sr, sc)
        self._coeffs = self._forward_pyramid(self._image)
        self._state = W_FORWARD
        return self

    def inverse(self):
        """Inverse transform (pypwt.pyx:347-358 / wt.cu:271-305).

        Calling inverse() twice is refused, as in the reference (whose
        buffer reuse destroys the coefficients)."""
        if self._state == W_INVERSE:
            print("Warning: W.inverse() has already been run. Inverse is "
                  "available in W.image")
            return self
        self._image = self._inverse_pyramid(self._coeffs)
        if self.do_cycle_spinning:
            sr, sc = self.current_shift
            self._image = self._circshift_image(self._image, -sr, -sc)
        self._state = W_INVERSE
        return self

    def _circshift_image(self, x, sr, sc):
        # a batched-1D plan shifts along its rows only, every row by the
        # same amount (common.cu:386 passes sr=0 for ndims==1)
        return thresh.circshift(x, 0 if self._eff_ndim == 1 else sr, sc)

    def circshift(self, sr, sc):
        """Circular shift of the current image (wt.cu:362-366); a 1D plan
        ignores ``sr``."""
        self._image = self._circshift_image(self._image, sr, sc)
        return self

    # ------------------------------------------------------------------
    # coefficients access
    # ------------------------------------------------------------------

    def _guard_coeffs(self):
        if self._state == W_INVERSE:
            raise RuntimeError(
                "Wavelets: inverse() has been performed, the coefficients "
                "do not make sense anymore (run forward() again)")

    def _coeff_index(self, num):
        """(level, subband) of coefficient ``num`` (pypwt.pyx:261-286): 2D
        0=A, 1=H1, 2=V1, 3=D1, 4=H2, ...; 1D 0=A, i=Di.  Subband None
        where the level holds one tensor (A, 1D details)."""
        if num == 0:
            return 0, None
        if self._eff_ndim == 1:
            level, sub = num, None
        else:
            level, sub = (num - 1) // 3 + 1, (num - 1) % 3
        if level > self.levels:
            raise ValueError(f"coefficient {num} out of range")
        return level, sub

    def _coeff_ref(self, num):
        level, sub = self._coeff_index(num)
        c = self._coeffs[level]
        return c if sub is None else c[sub]

    def coeff_only(self, num):
        """Copy one coefficient plane to the host (pypwt.pyx:261-286)."""
        self._guard_coeffs()
        return self._coeff_ref(num).cpu().numpy()

    @property
    def coeffs(self):
        """All coefficients as numpy arrays, [A, [H1,V1,D1], ...] in 2D and
        [A, D1, ...] in 1D (pypwt.pyx:289-305)."""
        self._guard_coeffs()
        out = [self._coeffs[0].cpu().numpy()]
        for c in self._coeffs[1:]:
            out.append(c.cpu().numpy() if self._eff_ndim == 1
                       else [s.cpu().numpy() for s in c])
        return out

    def set_coeff(self, coeff, num, check=False):
        """Overwrite one coefficient plane (pypwt.pyx:463-484)."""
        coeff = self._checkarray(coeff)
        ref = self._coeff_ref(num)
        if check and tuple(coeff.shape) != tuple(ref.shape):
            raise ValueError(
                "set_coeff: Invalid coefficient shape : expected %s, got %s"
                % (str(tuple(ref.shape)), str(tuple(coeff.shape))))
        new = coeff.reshape(ref.shape)
        level, sub = self._coeff_index(num)
        c = list(self._coeffs)
        if sub is None:
            c[level] = new
        else:
            planes = list(c[level])
            planes[sub] = new
            c[level] = tuple(planes)
        self._coeffs = c

    @property
    def image(self):
        """Current image as a (Nr, Nc) numpy array (pypwt.pyx:308-315)."""
        return self._image.cpu().numpy().reshape(self.Nr, self.Nc)

    def set_image(self, img):
        self._image = self._checkarray(img, self.shape)
        self._state = W_INIT

    # device-side access (the analog of image_int_ptr/coeff_int_ptr,
    # pypwt.pyx:578-592: hand out the device tensors themselves)
    def image_device_array(self):
        return self._image

    def coeff_device_array(self, num):
        self._guard_coeffs()
        return self._coeff_ref(num)

    # ------------------------------------------------------------------
    # proximal operators / norms
    # ------------------------------------------------------------------

    def _guard_thresh(self):
        if self._state == W_INVERSE:
            raise RuntimeError(
                "Wavelets: cannot threshold coefficients, as they were "
                "modified by W.inverse()")

    def soft_threshold(self, beta, do_threshold_appcoeffs=0, normalize=0):
        self._guard_thresh()
        self._coeffs = thresh.soft_threshold(
            self._coeffs, float(beta), bool(do_threshold_appcoeffs),
            bool(normalize))

    def hard_threshold(self, beta, do_threshold_appcoeffs=0, normalize=0):
        self._guard_thresh()
        self._coeffs = thresh.hard_threshold(
            self._coeffs, float(beta), bool(do_threshold_appcoeffs),
            bool(normalize))

    def group_soft_threshold(self, beta, do_threshold_appcoeffs=0,
                             normalize=0):
        self._guard_thresh()
        self._coeffs = thresh.group_soft_threshold(
            self._coeffs, float(beta), bool(do_threshold_appcoeffs),
            bool(normalize))

    def proj_linf(self, beta, do_threshold_appcoeffs=0):
        self._guard_thresh()
        self._coeffs = thresh.proj_linf(
            self._coeffs, float(beta), bool(do_threshold_appcoeffs))

    def shrink(self, beta, do_threshold_appcoeffs=1):
        self._guard_thresh()
        self._coeffs = thresh.shrink(
            self._coeffs, float(beta), bool(do_threshold_appcoeffs))

    def norm1(self):
        return float(thresh.norm1(self._coeffs))

    def norm2sq(self):
        return float(thresh.norm2sq(self._coeffs))

    def add_wavelet(self, W, alpha=1.0):
        """In-place coefficient axpy (wt.cu:622-655)."""
        if (self.levels != W.levels
                or self.wname.lower() != W.wname.lower()):
            raise ValueError(
                "add_wavelet(): right operand is not the same transform "
                "(wname, level)")
        if self._state == W_INVERSE or W._state == W_INVERSE:
            print("WARNING: add_wavelet(): this operation makes no sense "
                  "when wavelet has just been inverted")
            return 1
        if ((self.Nr, self.Nc, self.ndim, self._eff_ndim)
                != (W.Nr, W.Nc, W.ndim, W._eff_ndim)):
            raise ValueError(
                "add_wavelet(): operands do not have the same geometry")
        if bool(self.do_swt) != bool(W.do_swt):
            raise ValueError(
                "add_wavelet(): operands should both use SWT or DWT")
        if (self.do_cycle_spinning and W.do_cycle_spinning
                and self.current_shift != W.current_shift):
            raise ValueError(
                "add_wavelet(): operands do not have the same current shift")
        self._coeffs = thresh.add_coeffs(self._coeffs, W._coeffs,
                                         float(alpha))
        return 0

    # ------------------------------------------------------------------
    # custom filter banks
    # ------------------------------------------------------------------

    def set_wavelets_filters(self, filter_name, lowpass, highpass,
                             i_lowpass, i_highpass, LH=None, HL=None,
                             i_LH=None, i_HL=None):
        """Install a custom filter bank (pypwt.pyx:487-576).

        Separable: four 1D arrays (dec_lo, dec_hi, rec_lo, rec_hi).
        Non-separable: lowpass/highpass are the LL/HH 2D filters plus the
        LH/HL ones (and their inverses), all squares of one size.
        """
        lowpass = np.asarray(lowpass, dtype=np.float64)
        arrays = [lowpass, highpass, i_lowpass, i_highpass, LH, HL, i_LH,
                  i_HL]
        if any(a is not None and len(a) != len(lowpass) for a in arrays):
            raise ValueError("All filters must have the same length")
        if len(lowpass) > MAX_FILTER_WIDTH:
            raise ValueError("filter too long (max %d)" % MAX_FILTER_WIDTH)
        if not self.do_separable and lowpass.ndim != 2:
            raise ValueError(
                "non-separable custom filters must be 2D square arrays "
                "(pypwt.pyx:487-576 passes LL/LH/HL/HH planes)")

        if self.do_separable:
            self._fb = FilterBank.custom(filter_name, lowpass, highpass,
                                         i_lowpass, i_highpass)
        else:
            if LH is None or HL is None or i_LH is None or i_HL is None:
                raise ValueError(
                    "Expected LH and HL filters for non-separable transform")
            dec = [np.asarray(a, dtype=np.float64)
                   for a in (lowpass, LH, HL, highpass)]
            rec = [np.asarray(a, dtype=np.float64)
                   for a in (i_lowpass, i_LH, i_HL, i_highpass)]
            self._f2d = nonsep.Filters2D(dec, rec, name=filter_name)
            self._fb = None
        self.wname = filter_name
        self.hlen = len(lowpass)
        # the reference keeps the existing plan: levels stay unchanged
        self._state = W_INIT

    # ------------------------------------------------------------------
    # info
    # ------------------------------------------------------------------

    def info(self):
        print(self._info_str())

    def _info_str(self):
        yn = {0: "no", 1: "yes"}
        if self.device.type == "cuda":
            dev = torch.cuda.get_device_name(self.device)
        else:
            dev = str(self.device)
        if self._eff_ndim == 2:
            dims = f"({self.Nr}, {self.Nc})"
        elif self.Nr == 1:
            dims = f"{self.Nc}"
        else:
            dims = f"({self.Nr}, {self.Nc}) [batched 1D transform]"
        # footprint model (wt.cu:527-538): image + coefficients
        if not self.do_swt:
            mem = 2 * self.Nr * self.Nc * 4
        elif self._eff_ndim == 2:
            mem = (3 * self.levels + 2) * self.Nr * self.Nc * 4
        else:
            mem = (self.levels + 2) * self.Nr * self.Nc * 4
        return "\n".join([
            "------------- Wavelet transform infos ------------",
            f"Data dimensions : {dims}",
            f"Wavelet name : {self.wname}",
            f"Number of levels : {self.levels}",
            f"Stationary WT : {yn[self.do_swt]}",
            f"Cycle spinning : {yn[self.do_cycle_spinning]}",
            f"Separable transform : {yn[self.do_separable]}",
            "Estimated memory footprint : %.2f MB" % (mem / 1e6),
            f"Running on device : {dev}",
            "--------------------------------------------------",
        ])

    def __repr__(self):
        return self._info_str()

    @classmethod
    def version(cls):
        return __version__
