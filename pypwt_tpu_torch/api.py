"""Reference-compatible ``Wavelets`` class on PyTorch (the separable 2D DWT
part of ``pypwt_tpu.api``).

Mirrors the Cython class (src/pypwt.pyx:64-615) and the C++ plan object
(pdwt/src/wt.cu:84-305): the constructor puts the image on ``device``,
``forward()``/``inverse()`` run the level loops of ``core.dwt`` (on a CUDA
device through the K1/K2 kernels), coefficients live on the device and are
copied back on access, and the reference's state machine (coefficients are
declared invalid after ``inverse()``) is kept.

Ported so far: the separable, decimated 2D transform (any of the 72 banks
or a custom separable bank), thresholds, norms, ``add_wavelet`` and cycle
spinning.  SWT, 1D / batched-1D and non-separable transforms raise
``NotImplementedError`` naming the ROADMAP.md item that brings them.
"""

from __future__ import annotations

import numpy as np
import torch

from .filters import FilterBank, MAX_FILTER_WIDTH, get_filter_bank
from .core import dwt, haar, thresh
from .core.shapes import clamp_levels, div2, level_shapes_2d
from .version import __version__

# state machine (wt.h:8-17)
W_INIT = "INIT"
W_FORWARD = "FORWARD"
W_INVERSE = "INVERSE"

_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.float64): torch.float64}


def _not_ported(what, item):
    return NotImplementedError(
        f"{what} is not ported to pypwt_tpu_torch yet (ROADMAP.md queue 1: "
        f"{item}); pypwt_tpu.Wavelets has it")


class Wavelets:
    """Wavelet transform plan bound to one image geometry.

    img: 2D array (numpy array or tensor; float32 coerced, like
    pypwt.pyx:224-235)
    wname: wavelet name (72 built-ins)
    levels: decomposition levels (clamped like wt.cu:155-165)
    do_separable / do_cycle_spinning / do_swt: mode flags
    ndim: 2 (ndim=1, batched 1D, is not ported yet)
    seed: seed of the numpy generator that draws cycle-spinning shifts
    device: torch device of the image and coefficients ("cuda" runs the
    K1/K2 kernels, "cpu" the plain torch path)
    """

    def __init__(self, img, wname, levels, do_separable=1,
                 do_cycle_spinning=0, do_swt=0, ndim=2, seed=None,
                 dtype=np.float32, device="cuda"):
        self.dtype = np.dtype(dtype)
        if self.dtype not in _DTYPES:
            raise ValueError("dtype must be float32 or float64")
        self.device = torch.device(device)
        if do_swt:
            raise _not_ported("The stationary transform (do_swt=1)",
                              "'core/swt.py'")
        if not do_separable:
            raise _not_ported("The non-separable transform (do_separable=0)",
                              "'core/nonsep.py'")
        img = self._checkarray(img)
        if img.ndim == 1 or int(ndim) == 1:
            raise _not_ported("The 1D and batched-1D transform",
                              "'1D and batched-1D'")
        if img.ndim != 2:
            raise NotImplementedError(
                "Wavelets(): Only 1D and 2D transforms are supported for now")
        self.Nr, self.Nc = img.shape
        self.shape = tuple(img.shape)
        self.ndim = 2

        self.wname = wname
        self.do_separable = 1
        self.do_cycle_spinning = int(bool(do_cycle_spinning))
        self.do_swt = 0

        self._fb = get_filter_bank(wname)
        self.hlen = self._fb.hlen
        self.levels = clamp_levels(int(levels), (self.Nr, self.Nc),
                                   self._fb.hlen, 2)
        self.sizes = level_shapes_2d(self.Nr, self.Nc, self.levels, False)
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

    def _zero_coeffs(self):
        def z(shape):
            return torch.zeros(shape, dtype=_DTYPES[self.dtype],
                               device=self.device)
        out = [z(self.sizes[self.levels - 1])]
        for i in range(self.levels):
            out.append(tuple(z(self.sizes[i]) for _ in range(3)))
        return out

    def _forward_pyramid(self, x):
        if self._fb.hlen == 2:
            return haar.haar_wavedec2(x, self.levels)
        return dwt.wavedec2(x, self._fb, self.levels)

    def _inverse_pyramid(self, coeffs):
        if self._fb.hlen == 2:
            return haar.haar_waverec2(coeffs, self.shape)
        return dwt.waverec2(coeffs, self._fb, self.shape)

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
            self._image = thresh.circshift(self._image, sr, sc)
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
            self._image = thresh.circshift(self._image, -sr, -sc)
        self._state = W_INVERSE
        return self

    def circshift(self, sr, sc):
        """Circular shift of the current image (wt.cu:362-366)."""
        self._image = thresh.circshift(self._image, sr, sc)
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
        """(level, subband) of coefficient ``num``: 0=A, 1=H1, 2=V1, 3=D1,
        4=H2, ... (pypwt.pyx:261-286); subband None for A."""
        if num == 0:
            return 0, None
        level = (num - 1) // 3 + 1
        if level > self.levels:
            raise ValueError(f"coefficient {num} out of range")
        return level, (num - 1) % 3

    def _coeff_ref(self, num):
        level, sub = self._coeff_index(num)
        return self._coeffs[0] if sub is None else self._coeffs[level][sub]

    def coeff_only(self, num):
        """Copy one coefficient plane to the host (pypwt.pyx:261-286)."""
        self._guard_coeffs()
        return self._coeff_ref(num).cpu().numpy()

    @property
    def coeffs(self):
        """All coefficients as [A, [H1,V1,D1], ...] numpy arrays
        (pypwt.pyx:289-305)."""
        self._guard_coeffs()
        out = [self._coeffs[0].cpu().numpy()]
        for i in range(1, self.levels + 1):
            out.append([s.cpu().numpy() for s in self._coeffs[i]])
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
            c[0] = new
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
        if (self.Nr, self.Nc, self.ndim) != (W.Nr, W.Nc, W.ndim):
            raise ValueError(
                "add_wavelet(): operands do not have the same geometry")
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
                             i_lowpass, i_highpass):
        """Install a custom separable filter bank (pypwt.pyx:487-576):
        four 1D arrays (dec_lo, dec_hi, rec_lo, rec_hi)."""
        lowpass = np.asarray(lowpass, dtype=np.float64)
        if any(len(a) != len(lowpass)
               for a in (highpass, i_lowpass, i_highpass)):
            raise ValueError("All filters must have the same length")
        if len(lowpass) > MAX_FILTER_WIDTH:
            raise ValueError("filter too long (max %d)" % MAX_FILTER_WIDTH)
        self._fb = FilterBank.custom(filter_name, lowpass, highpass,
                                     i_lowpass, i_highpass)
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
        mem = 2 * self.Nr * self.Nc * 4
        return "\n".join([
            "------------- Wavelet transform infos ------------",
            f"Data dimensions : ({self.Nr}, {self.Nc})",
            f"Wavelet name : {self.wname}",
            f"Number of levels : {self.levels}",
            f"Stationary WT : {yn[self.do_swt]}",
            f"Cycle spinning : {yn[self.do_cycle_spinning]}",
            f"Separable transform : {yn[self.do_separable]}",
            # footprint model (wt.cu:527-538): image + coefficients
            "Estimated memory footprint : %.2f MB" % (mem / 1e6),
            f"Running on device : {dev}",
            "--------------------------------------------------",
        ])

    def __repr__(self):
        return self._info_str()

    @classmethod
    def version(cls):
        return __version__
