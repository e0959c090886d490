# Frozen copy of glaze_tpu_torch/core/spectrum.py for the benchmark's plain
# reference (benchmark/README.md): imports rewritten to benchmark.ref.
"""16-bin spectral color representation (400-700nm @ 20nm).

Port of the reference's spectral pipeline
(``lib/src/geometry/spectrum.rs``): Smits-style RGB->spectrum
with separate reflectance/illuminant bases, CIE X/Y/Z integration tables, and
blackbody emission.  The module-level tables are plain NumPy arrays so the JAX
ops layer (:mod:`benchmark.ref.ops.spectra`) can reuse them on device.
"""

from __future__ import annotations

import math

import numpy as np

SAMPLES = 16
INTERVAL_NM = 20.0
START_NM = 400.0

# Inverse of the integral of the CIE Y curve over the sampled range
# (spectrum.rs:215).
INVY_SUM = 0.17557178

# CIE color matching functions, resampled to the 16 bins (spectrum.rs:217-278).
CIE_X = np.array([
    0.048547909657160444, 0.24864331478873888, 0.33913105790813763,
    0.23759311571717262, 0.068513086394717301, 0.0074335845497747266,
    0.08596576422452927, 0.30151855826377871, 0.58514208267132439,
    0.88403650492429731, 1.0476295638084412, 0.91729557037353515,
    0.55824810008207959, 0.24846323480208715, 0.082662385882188882,
    0.023565863414357107,
], dtype=np.float32)

CIE_Y = np.array([
    0.0013634899475922187, 0.010440415943351884, 0.033597446996718648,
    0.077808559965342278, 0.16970793592433134, 0.38263264827430249,
    0.73335171341896055, 0.95049857179323827, 0.98971243401368458,
    0.88304891208807623, 0.67035055945316946, 0.43439004709323248,
    0.22639957609275976, 0.093565923050045963, 0.030277141408684354,
    0.0085307513410225518,
], dtype=np.float32)

CIE_Z = np.array([
    0.23185277074575425, 1.2145957302053769, 1.7617404375473658,
    1.4557389440139135, 0.66370667571822806, 0.24021451229850452,
    0.075098564475774759, 0.020824563254912696, 0.0045391401535986612,
    0.0017035374639090151, 0.00090068979518643274, 0.00025727244249234595,
    3.9191220954914268e-05, 1.964333174934533e-06, 0.0, 0.0,
], dtype=np.float32)

# Smits-style basis spectra for reflectance (spectrum.rs:281-573).
SPECTRUM_WHITE = np.array([
    1.0619347266616228, 1.0623373513955183, 1.0624330274817486,
    1.0624850787200137, 1.0622213950288308, 1.0613081599651542,
    1.0613058645182336, 1.0618168659745209, 1.0624642293010491,
    1.0624838864140043, 1.0624682453762331, 1.0625355983287506,
    1.0624016329348598, 1.0622653248789862, 1.060266533148627,
    1.0600420908765831,
], dtype=np.float32)

SPECTRUM_WHITEL = np.array([
    1.1560446394211681, 1.1564162465744781, 1.1567872929485827,
    1.1565328954114107, 1.1565926830659454, 1.1565499678850697,
    1.1472133116300325, 1.1314209727068025, 1.096408860125702,
    1.0338718350511178, 0.96528604465789958, 0.92067216838305188,
    0.90011672087937411, 0.88940075523174911, 0.88083842252481404,
    0.87810499922653207,
], dtype=np.float32)

SPECTRUM_CYAN = np.array([
    1.0240953312699979, 1.0245612457188975, 1.0463755555238345,
    1.0327846651059092, 1.0478428969483209, 1.0535090536305822,
    1.0534870576691449, 1.0530663848751949, 1.0549102750144981,
    0.94299173220279198, 0.3100097408600444, 0.0033711342032203243,
    -0.0048549813110745684, 0.0018582205785167482, 0.0039837672915054804,
    0.010507259067086385,
], dtype=np.float32)

SPECTRUM_CYANL = np.array([
    1.1352399582424499, 1.1358531764433719, 1.1362707169771014,
    1.1359364376354608, 1.1361867189829913, 1.135817770159788,
    1.1359519356976406, 1.135423392708292, 1.1224513886352236,
    0.87073337556349084, 0.3803441995397272, 0.051216852241201545,
    -0.011762638745943615, -0.01060685685959013, -0.006931473364874461,
    -0.0077818774183695668,
], dtype=np.float32)

SPECTRUM_MAGENTA = np.array([
    0.99302530302633674, 1.0170691330352013, 1.0143947530476214,
    1.0070517895374196, 0.80112726913173504, 0.077593476678434567,
    0.003229957831351733, -0.004352238640709956, 0.0026944590704797754,
    0.28205531033673215, 0.8570353689334701, 0.99378492125784268,
    0.98449588288224388, 0.8937980881442511, 0.94958431903872431,
    0.9395992587226637,
], dtype=np.float32)

SPECTRUM_MAGENTAL = np.array([
    1.0765584064227334, 1.0770490751029975, 1.0731253134738323,
    1.0796647470180021, 1.0024747756009726, 0.4395828981593643,
    0.02042973274257508, -0.0015031343728669692, -6.099749699375323e-06,
    0.072151645981868115, 0.48078616824947817, 0.97313406556425108,
    1.0781818622728534, 1.0327505540054573, 1.0495214724241742,
    1.0257450908661028,
], dtype=np.float32)

SPECTRUM_YELLOW = np.array([
    -0.0059362362867909409, -0.0040293484704144403, 0.034632747920561285,
    0.19407661745186114, 0.45561541868250915, 0.78117265145981962,
    1.0163873556505527, 1.0511958466847318, 1.0513470268321483,
    1.0515277720869929, 1.0512298920801075, 1.0515211534901903,
    1.0514264026060656, 1.0513103386739624, 1.0507004197273715,
    1.0485826837788901,
], dtype=np.float32)

SPECTRUM_YELLOWL = np.array([
    0.0001468672999305493, -0.00013161147654402951, -0.00016768424395723818,
    0.089519214436320216, 0.74821476916582985, 1.0340727288469598,
    1.0365778653585402, 1.0367058054560021, 1.0365194490895373,
    1.03661227107821, 1.0361321399468379, 1.0144985871415191,
    0.8293751396865352, 0.6705682032005652, 0.60059597683336108,
    0.58277723714307716,
], dtype=np.float32)

SPECTRUM_RED = np.array([
    0.11487922506830811, 0.060141120462551691, 0.0040665397109191335,
    0.010459427718803191, 0.0035470993579631675, -0.0052706076654779289,
    -0.0062588252221244959, -0.0086496045197971341, 0.00097200190739861079,
    0.14679380036909495, 0.85847180162874637, 0.99821493324988597,
    0.99605297040670981, 1.0018494025816944, 0.99593834054491903,
    0.9811979963396622,
], dtype=np.float32)

SPECTRUM_REDL = np.array([
    0.057139392791085111, 0.043034047329456572, 0.021260689526515806,
    0.001077172714861781, 0.00057985241220036873, -0.00022486144117236386,
    -0.00012009820021618776, -0.0001991308173681336, 0.012756076079520295,
    0.1832461591194777, 0.51948819108311795, 0.82120171360154059,
    0.96263010562297358, 0.99410699787589729, 0.99018057306059759,
    0.98278552726948454,
], dtype=np.float32)

SPECTRUM_GREEN = np.array([
    -0.010865527381003439, -0.010329458431599345, -0.0083431520558099291,
    0.083794233190453149, 0.57500780803880425, 0.95115677422179923,
    0.99948898769838934, 0.99968078182605802, 0.9988159758735875,
    0.88618140828021486, 0.35690377193776984, 0.01325598457467465,
    -0.0050991929756587905, -0.0083927995026960873, -0.0084413650357697944,
    -0.0047501377518373699,
], dtype=np.float32)

SPECTRUM_GREENL = np.array([
    0.0064830780912117957, 0.00019032331867488899, -0.0081060480798639516,
    0.048161890183585902, 0.66729637282872345, 1.0307844454225901,
    1.0311600157417389, 1.0265626896736526, 1.0363099387922192,
    1.0120735391513225, 0.32668720729539291, 0.0033846154767388065,
    0.0081701266623202973, 0.0088889810224966476, 0.00036631914529600032,
    0.00099462806143045101,
], dtype=np.float32)

SPECTRUM_BLUE = np.array([
    0.99498216185557875, 0.99569451590852531, 0.99983310193704411,
    0.9648523926660395, 0.67060127526424484, 0.29157891777810102,
    0.044614561825850822, -6.7793271695393519e-06, 0.00050597357489660954,
    0.0023497993510693772, 0.00067442519549839989, 0.016621955742817246,
    0.040211692914411255, 0.049604490414015802, 0.043574051087547458,
    0.027483432250758107,
], dtype=np.float32)

SPECTRUM_BLUEL = np.array([
    1.054236254920313, 1.0576206026996142, 1.058143833550661,
    1.0568818098511983, 1.0207912014756255, 0.2974275399820579,
    -0.0014770394250804989, -0.0013982161133251694, -0.00059190711447091779,
    -0.0010090527379278194, -0.0015479588813372375, 0.0051106864601078716,
    0.047054873524993275, 0.12827536395203271, 0.15246421103968871,
    0.16615733676564479,
], dtype=np.float32)

# Basis sets in the order used by from_rgb: white, cyan, magenta, yellow,
# red, green, blue (spectrum.rs:81-101).
SURFACE_BASIS = np.stack([
    SPECTRUM_WHITE, SPECTRUM_CYAN, SPECTRUM_MAGENTA, SPECTRUM_YELLOW,
    SPECTRUM_RED, SPECTRUM_GREEN, SPECTRUM_BLUE,
])
ILLUMINANT_BASIS = np.stack([
    SPECTRUM_WHITEL, SPECTRUM_CYANL, SPECTRUM_MAGENTAL, SPECTRUM_YELLOWL,
    SPECTRUM_REDL, SPECTRUM_GREENL, SPECTRUM_BLUEL,
])
SURFACE_SCALE = 0.94
ILLUMINANT_SCALE = 0.86445


def rgb_to_spectrum_np(rgb: np.ndarray, is_light: bool) -> np.ndarray:
    """Vectorized Smits RGB->spectrum, matching spectrum.rs:79-139.

    ``rgb``: (..., 3) float. Returns (..., 16) float32.
    Reference clamps the result to [0, 1].
    """
    rgb = np.asarray(rgb, dtype=np.float32)
    basis = ILLUMINANT_BASIS if is_light else SURFACE_BASIS
    white, cyan, magenta, yellow, red, green, blue = basis
    r, g, b = rgb[..., 0:1], rgb[..., 1:2], rgb[..., 2:3]
    res = np.zeros(rgb.shape[:-1] + (SAMPLES,), dtype=np.float32)

    # branch 1: r smallest
    m1 = (r <= g) & (r <= b)
    m1a = m1 & (g <= b)
    m1b = m1 & ~(g <= b)
    res = np.where(m1, r * white, res)
    res = np.where(m1a, res + (g - r) * cyan + (b - g) * blue, res)
    res = np.where(m1b, res + (b - r) * cyan + (g - b) * green, res)
    # branch 2: g smallest
    m2 = ~m1 & (g <= r) & (g <= b)
    m2a = m2 & (r <= b)
    m2b = m2 & ~(r <= b)
    res = np.where(m2, g * white, res)
    res = np.where(m2a, res + (r - g) * magenta + (b - r) * blue, res)
    res = np.where(m2b, res + (b - g) * magenta + (r - b) * red, res)
    # branch 3: b smallest
    m3 = ~m1 & ~m2
    m3a = m3 & (r <= g)
    m3b = m3 & ~(r <= g)
    res = np.where(m3, b * white, res)
    res = np.where(m3a, res + (r - b) * yellow + (g - r) * green, res)
    res = np.where(m3b, res + (g - b) * yellow + (r - g) * red, res)

    scale = ILLUMINANT_SCALE if is_light else SURFACE_SCALE
    return np.clip(res * scale, 0.0, 1.0)


class Spectrum:
    """A spectral color: 16 samples, 400-700nm at 20nm intervals."""

    SAMPLES = SAMPLES
    INTERVAL_NM = INTERVAL_NM
    START_NM = START_NM

    __slots__ = ("wavelength",)

    def __init__(self, wavelength=None):
        if wavelength is None:
            self.wavelength = np.zeros(SAMPLES, dtype=np.float32)
        else:
            arr = np.asarray(wavelength, dtype=np.float32).reshape(SAMPLES)
            self.wavelength = arr.copy()

    # -- constructors -----------------------------------------------------
    @staticmethod
    def black() -> "Spectrum":
        return Spectrum()

    @staticmethod
    def white() -> "Spectrum":
        return Spectrum(SPECTRUM_WHITE)

    @staticmethod
    def from_blackbody(temperature: float) -> "Spectrum":
        """Normalized blackbody emission spectrum (spectrum.rs:44-69)."""
        if temperature <= 0.0:
            return Spectrum.black()
        planck_h = np.float32(6.62606957e-34)
        boltzmann_k = np.float32(1.38064852e-23)
        c = np.float32(299792458.0)
        w = np.zeros(SAMPLES, dtype=np.float32)
        current = np.float32(START_NM * 1e-9)
        for i in range(SAMPLES):
            first_term = np.float32(2.0) * planck_h * c * c / np.float32(current) ** 5
            exp_term = planck_h * c / (
                np.float32(current) * np.float32(temperature) * boltzmann_k
            )
            w[i] = first_term * np.float32(1.0) / np.float32(math.expm1(exp_term))
            current = current + np.float32(INTERVAL_NM * 1e-9)
        maxval = w.max()
        w = np.clip(w * (np.float32(1.0) / maxval), 0.0, 1.0)
        return Spectrum(w)

    @staticmethod
    def from_rgb(rgb, is_light: bool) -> "Spectrum":
        from benchmark.ref.core.color import ColorRGB

        if isinstance(rgb, ColorRGB):
            rgb = np.array([rgb.r, rgb.g, rgb.b], dtype=np.float32)
        return Spectrum(rgb_to_spectrum_np(np.asarray(rgb, np.float32), is_light))

    # -- conversions ------------------------------------------------------
    def to_xyz(self):
        from benchmark.ref.core.color import ColorXYZ

        scale = np.float32(100.0 * INVY_SUM)
        x = float(max((self.wavelength * CIE_X).sum() * scale, 0.0))
        y = float(max((self.wavelength * CIE_Y).sum() * scale, 0.0))
        z = float(max((self.wavelength * CIE_Z).sum() * scale, 0.0))
        return ColorXYZ(x, y, z)

    def luminance(self) -> float:
        y = float((self.wavelength * CIE_Y).sum() * np.float32(INVY_SUM))
        return min(max(y, 0.0), 1.0)

    # -- serialization ----------------------------------------------------
    def to_le_bytes(self) -> bytes:
        return self.wavelength.astype("<f4").tobytes()

    @staticmethod
    def from_le_bytes(data: bytes) -> "Spectrum":
        return Spectrum(np.frombuffer(data, dtype="<f4", count=SAMPLES))

    # -- operators ---------------------------------------------------------
    def _coerce(self, other):
        if isinstance(other, Spectrum):
            return other.wavelength
        return np.float32(other)

    def __add__(self, other):
        return Spectrum(self.wavelength + self._coerce(other))

    def __sub__(self, other):
        return Spectrum(self.wavelength - self._coerce(other))

    def __mul__(self, other):
        return Spectrum(self.wavelength * self._coerce(other))

    def __truediv__(self, other):
        return Spectrum(self.wavelength / self._coerce(other))

    __radd__ = __add__
    __rmul__ = __mul__

    def __iadd__(self, other):
        self.wavelength = self.wavelength + self._coerce(other)
        return self

    def __isub__(self, other):
        self.wavelength = self.wavelength - self._coerce(other)
        return self

    def __imul__(self, other):
        self.wavelength = self.wavelength * self._coerce(other)
        return self

    def __itruediv__(self, other):
        self.wavelength = self.wavelength / self._coerce(other)
        return self

    def __eq__(self, other):
        return isinstance(other, Spectrum) and bool(
            np.array_equal(self.wavelength, other.wavelength)
        )

    def __repr__(self):
        return f"Spectrum({self.wavelength.tolist()})"

    def copy(self) -> "Spectrum":
        return Spectrum(self.wavelength)
