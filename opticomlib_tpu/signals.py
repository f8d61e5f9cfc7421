"""Signal type system: pytree containers with signal/noise dual-track algebra.

JAX re-design of the reference data model
(reference: opticomlib/typing.py:402-2427).  Design differences from the
reference:

* Containers are registered as JAX pytrees, so they flow through ``jax.jit``
  / ``vmap`` / ``shard_map`` transparently — the JAX replacement for the
  reference's NumPy ``__array_ufunc__`` protocol integration
  (typing.py:518-692, 1224-1306).
* Arrays inside are whatever the caller provides (NumPy on host, jax.Array on
  device); all algebra below uses operators + ufuncs that dispatch on both.
* "No noise" is represented by the absorbing :data:`NULL` sentinel, matching
  the reference semantics (typing.py:56-93): ``x + NULL == x``,
  ``x * NULL == NULL`` — so noiseless paths cost nothing.

Noise propagation identities (reference typing.py:1337-1344, 1400-1419):

* ``(s1,n1) * (s2,n2) -> (s1*s2, s1*n2 + n1*s2 + n1*n2)``
* ``(s,n) ** 2        -> (s**2,  2*s*n + n**2)``

These are what let the photodetector split signal-ASE / ASE-ASE beat noise
analytically (reference devices.py:1460-1479).
"""
from __future__ import annotations

from typing import Iterable, Literal, Optional, Union

import numpy as np
import jax

from .params import gv
from .utils.analysis import (
    dbm, db, si, str2array, shortest_int, _is_arraylike,
)

__all__ = [
    "NULL", "NULLType",
    "BinarySequence", "ElectricalSignal", "OpticalSignal",
    "binary_sequence", "electrical_signal", "optical_signal",
    "Array_Like", "RealNumber", "ComplexNumber",
]

Array_Like = (list, tuple, np.ndarray)
RealNumber = (int, float, np.integer, np.floating)
ComplexNumber = RealNumber + (complex, np.complexfloating)


# ---------------------------------------------------------------------------
# NULL sentinel (reference typing.py:56-93)
# ---------------------------------------------------------------------------
class NULLType:
    """Absorbing zero-like sentinel for 'no noise'.

    ``x + NULL -> x``; ``x * NULL -> NULL``; ``-NULL -> NULL``.  Singleton.
    """

    _instance = None
    __array_ufunc__ = None  # force numpy to defer to our reflected ops
    __array_priority__ = 1000

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "NULL"

    def __bool__(self):
        return False

    # additive identity
    def __add__(self, other):
        return other

    __radd__ = __add__

    def __sub__(self, other):
        return -other

    def __rsub__(self, other):
        return other

    def __neg__(self):
        return self

    # multiplicative absorber
    def __mul__(self, other):
        return self

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self

    def __pow__(self, other):
        return self

    def conj(self):
        return self

    def __getitem__(self, key):
        return self

    def sum(self, axis=None):
        return self


NULL = NULLType()


def _has_noise(noise) -> bool:
    return noise is not NULL and noise is not None


def _as_noise(noise):
    return noise if _has_noise(noise) else NULL


def _sizeof(obj) -> int:
    """Recursive in-memory size in bytes (reference uses pympler.asizeof,
    typing.py:13/824-830); falls back to array nbytes when pympler is
    unavailable."""
    try:
        from pympler.asizeof import asizeof
        return int(asizeof(obj))
    except Exception:
        total = 0
        for v in vars(obj).values():
            nb = getattr(v, "nbytes", None)
            total += int(nb) if nb is not None else 0
        return total


def _asarray(value, dtype=None):
    """Convert to an array, accepting str / scalars / array-likes / jax."""
    if isinstance(value, str):
        value = str2array(value)
    if isinstance(value, jax.Array):
        return value.astype(dtype) if dtype is not None else value
    return np.asarray(value, dtype=dtype)


# ---------------------------------------------------------------------------
# BinarySequence (reference typing.py:402-1009)
# ---------------------------------------------------------------------------
class BinarySequence:
    """1-D bit container (uint8).

    Accepts strings (``"1 0 1"``, ``"101"``, comma-separated), iterables and
    arrays of 0/1.  Supports bitwise operators, concatenation (``+``),
    repetition (``*``), slicing, and Hamming distance — behavioral parity
    with reference typing.py:402-1009.
    """

    def __init__(self, data: Union[str, Iterable, "BinarySequence"]):
        if isinstance(data, BinarySequence):
            arr = np.array(data.data, copy=True)
        elif isinstance(data, str):
            s = data.replace(",", " ").replace(";", " ").strip()
            if " " not in s:
                s = " ".join(s)  # "101" -> "1 0 1"
            arr = str2array(s, bool) if s else np.array([], dtype=bool)
        else:
            arr = np.asarray(data)
        arr = np.asarray(arr)
        if arr.ndim == 0:
            arr = arr[np.newaxis]
        if arr.ndim != 1:
            raise ValueError("Binary sequence must be 1-dimensional.")
        if arr.dtype != np.uint8:
            vals = np.asarray(arr)
            if not np.all((vals == 0) | (vals == 1)):
                raise ValueError(
                    "The binary sequence must contain only 0s and 1s!")
            arr = vals.astype(np.uint8)
        self.data = arr
        self.execution_time: float = 0.0

    # -- basic protocol --
    def __len__(self):
        return self.data.size

    def __iter__(self):
        return iter(self.data)

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self.data, dtype=dtype)

    # -- NumPy protocol integration (reference typing.py:518-692) --
    def __getattr__(self, name):
        # delegate array-like attribute access to the underlying ndarray
        # (reference typing.py:543-560): seq.max(), seq.cumsum(), ...
        if not name.startswith("_") and hasattr(np.ndarray, name):
            return getattr(np.asarray(
                object.__getattribute__(self, "data")), name)
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{name}'")

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        """np.add/np.multiply keep sequence semantics (concatenate/tile);
        other ufuncs apply to the bits and re-wrap binary results
        (reference typing.py:600-645)."""
        if method == "__call__" and not kwargs.get("out"):
            # sequence semantics regardless of which side the sequence is on
            if ufunc is np.add:
                lhs, rhs = inputs
                if isinstance(lhs, BinarySequence):
                    return lhs.__add__(rhs)
                if isinstance(rhs, BinarySequence):
                    return rhs.__radd__(lhs)
            if ufunc is np.multiply:
                lhs, rhs = inputs
                if isinstance(lhs, BinarySequence):
                    return lhs.__mul__(rhs)
                if isinstance(rhs, BinarySequence):
                    return rhs.__rmul__(lhs)
        new_inputs = [inp.__array__() if isinstance(inp, BinarySequence)
                      else inp for inp in inputs]
        result = getattr(ufunc, method)(*new_inputs, **kwargs)
        if isinstance(result, np.ndarray):
            try:
                return BinarySequence(result)
            except (ValueError, TypeError):
                pass
        return result

    def __array_function__(self, func, types, args, kwargs):
        """Higher-level NumPy functions (np.concatenate, np.roll, ...)
        apply to the bits and re-wrap binary results
        (reference typing.py:647-692)."""
        def _convert(obj):
            if isinstance(obj, BinarySequence):
                return obj.__array__()
            if isinstance(obj, (list, tuple)):
                return type(obj)(_convert(i) for i in obj)
            if isinstance(obj, dict):
                return {k: _convert(v) for k, v in obj.items()}
            return obj

        result = func(*_convert(args), **_convert(kwargs))
        if isinstance(result, np.ndarray):
            try:
                return BinarySequence(result)
            except (ValueError, TypeError):
                pass
        return result

    def to_numpy(self, dtype=None):
        return np.asarray(self.data, dtype=dtype)

    def __getitem__(self, key):
        out = self.data[key]
        if np.ndim(out) == 0:
            return int(out)
        return BinarySequence(out)

    def __repr__(self):
        return f"binary_sequence({self.data})"

    def __str__(self):
        ones = int(self.data.sum())
        n = self.data.size
        return (
            f"\nbinary_sequence: {self.data}\n"
            f"\tlen: {n}\n\tones: {ones}\n\tzeros: {n - ones}\n")

    def print(self, msg: Optional[str] = None):
        if msg:
            print(msg)
        print(self)
        return self

    # -- properties --
    @property
    def size(self) -> int:
        return int(self.data.size)

    @property
    def shape(self):
        return self.data.shape

    @property
    def ndim(self):
        return self.data.ndim

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def type(self):
        return type(self)

    @property
    def sizeof(self) -> int:
        """Memory size of the object in bytes (reference typing.py:824-830)."""
        return _sizeof(self)

    @property
    def ones(self) -> int:
        """Number of ones in the binary sequence (reference typing.py:797-801)."""
        return int(np.sum(self.data == 1))

    @property
    def zeros(self) -> int:
        """Number of zeros in the binary sequence (reference typing.py:804-808)."""
        return int(np.sum(self.data == 0))

    # -- operators --
    def _coerce(self, other) -> "BinarySequence":
        return other if isinstance(other, BinarySequence) else BinarySequence(other)

    def __add__(self, other):  # concatenation (reference semantics)
        other = self._coerce(other)
        return BinarySequence(np.concatenate([self.data, other.data]))

    def __radd__(self, other):
        other = self._coerce(other)
        return BinarySequence(np.concatenate([other.data, self.data]))

    def __mul__(self, n: int):  # repetition
        if not isinstance(n, (int, np.integer)):
            raise TypeError("Can only repeat a binary sequence by an integer.")
        return BinarySequence(np.tile(self.data, int(n)))

    __rmul__ = __mul__

    def __invert__(self):
        return BinarySequence(1 - self.data)

    def __and__(self, other):
        return BinarySequence(self.data & self._coerce(other).data)

    def __or__(self, other):
        return BinarySequence(self.data | self._coerce(other).data)

    def __xor__(self, other):
        return BinarySequence(self.data ^ self._coerce(other).data)

    def __eq__(self, other):
        return self.data == self._coerce(other).data

    def __ne__(self, other):
        return self.data != self._coerce(other).data

    def __hash__(self):
        return id(self)

    # -- methods --
    def hamming_distance(self, other) -> int:
        other = self._coerce(other)
        return int(np.sum(self.data != other.data))

    def flip(self):
        """Invert the binary sequence; same as ``~`` (reference typing.py:938-948)."""
        return ~self

    def dac(self, **kwargs):
        """Shortcut to :func:`opticomlib_tpu.devices.DAC`."""
        from .devices import DAC
        return DAC(self, **kwargs)

    @staticmethod
    def prbs(order: int, len: Optional[int] = None, seed: Optional[int] = None):
        from .ops.prbs import prbs as _prbs
        bits, _ = _prbs(order, length=len, seed=seed)
        return BinarySequence(bits)

    def plot(self, *args, **kwargs):  # pragma: no cover - host plotting
        import matplotlib.pyplot as plt
        n = kwargs.pop("n", self.size)
        plt.step(np.arange(n), self.data[:n], *args, where="post", **kwargs)
        return self

    def show(self):  # pragma: no cover
        import matplotlib.pyplot as plt
        plt.show()
        return self


# ---------------------------------------------------------------------------
# ElectricalSignal (reference typing.py:1022-2090)
# ---------------------------------------------------------------------------
class ElectricalSignal:
    """Complex baseband signal with a separately-tracked noise array.

    Registered as a JAX pytree: ``signal``/``noise`` are leaves, so instances
    can cross ``jit`` boundaries, be donated, sharded and vmapped.
    """

    n_pol = 1

    def __init__(self, signal, noise=NULL, dtype=None):
        if isinstance(signal, ElectricalSignal):
            sig, noi = signal.signal, signal.noise
            if _has_noise(noise):
                noi = noi + _asarray(noise, dtype)
        else:
            sig = _asarray(signal, dtype)
            noi = _asarray(noise, dtype) if _has_noise(noise) else NULL
        if np.ndim(sig) == 0:
            sig = sig[np.newaxis] if isinstance(sig, np.ndarray) else np.asarray([sig])
        if _has_noise(noi) and np.shape(noi) != np.shape(sig):
            if np.ndim(noi) == 0:  # scalar noise broadcasts over the signal
                noi = np.broadcast_to(np.asarray(noi), np.shape(sig)).copy()
            else:
                raise ValueError(
                    f"signal {np.shape(sig)} and noise {np.shape(noi)} "
                    "must have the same shape")
        self.signal = sig
        self.noise = _as_noise(noi)
        self.execution_time: float = 0.0

    # -- representation --
    def __str__(self, title: Optional[str] = None):
        title = title or self.__class__.__name__
        head = 3 * "*" + f"    {title}    " + 3 * "*"
        sub = len(head) * "-"
        np.set_printoptions(precision=3, threshold=20)
        pw_sig = float(np.sum(self.power("W", "signal")))
        pw_noi = float(np.sum(self.power("W", "noise")))
        pw_all = float(np.sum(self.power("W", "all")))

        def _dbm(p):
            return dbm(p) if p > 0 else -np.inf

        return (
            f"\n{sub}\n{head}\n{sub}\n"
            f"   signal:     {np.asarray(self.signal)} (shape: {self.shape})\n"
            f"   noise:      {self.noise if not _has_noise(self.noise) else np.asarray(self.noise)}\n"
            f"   pow_signal: {si(pw_sig, 'W', 1)} ({_dbm(pw_sig):.1f} dBm)\n"
            f"   pow_noise:  {si(pw_noi, 'W', 1)} ({_dbm(pw_noi):.1f} dBm)\n"
            f"   pow_total:  {si(pw_all, 'W', 1)} ({_dbm(pw_all):.1f} dBm)\n"
            f"   len:        {self.size}\n"
            f"   elem_type:  {self.dtype}\n"
            f"   time:       {si(self.execution_time, 's', 2)}\n")

    def __repr__(self):
        np.set_printoptions(precision=3, threshold=20)
        return f"{self.__class__.__name__}({np.asarray(self.signal)})"

    def print(self, msg: Optional[str] = None):
        print(self.__str__(msg))
        return self

    # -- conversion --
    def to_numpy(self, dtype=None, copy: bool = False) -> np.ndarray:
        data = self.signal + self.noise
        return np.array(data, dtype=dtype, copy=copy or None)

    def __array__(self, dtype=None, copy=None):
        return self.to_numpy(dtype)

    # -- NumPy protocol integration (reference typing.py:1224-1306) --
    def _wrap_array_result(self, result):
        """Re-wrap an ndarray result in the signal class when the shape is
        compatible (reference typing.py:1268-1275): 1-D for
        electrical_signal, 1-D/2-D for optical_signal."""
        if isinstance(result, np.ndarray):
            if type(self) is ElectricalSignal and result.ndim == 1:
                return ElectricalSignal(result)
            if isinstance(self, OpticalSignal) and result.ndim in (1, 2):
                return type(self)(result)
        return result

    def __getattr__(self, name):
        # ndarray attribute delegation (reference typing.py:1231-1238):
        # sig.var(), sig.max(), sig.cumsum(), sig.T ... act on signal+noise
        if not name.startswith("_") and hasattr(np.ndarray, name):
            return getattr(self.to_numpy(), name)
        raise AttributeError(
            f"'{type(self).__name__}' object has no attribute '{name}'")

    def __array_ufunc__(self, ufunc, method, *inputs, **kwargs):
        """np.add/np.subtract/np.multiply keep the signal/noise bilinear
        algebra; other ufuncs act on ``signal + noise`` and re-wrap
        shape-compatible results (reference typing.py:1241-1276)."""
        if method == "__call__" and not kwargs.get("out"):
            # bilinear algebra regardless of which side the signal is on
            if ufunc is np.add:
                lhs, rhs = inputs
                if isinstance(lhs, ElectricalSignal):
                    return lhs.__add__(rhs)
                if isinstance(rhs, ElectricalSignal):
                    return rhs.__add__(lhs)
            if ufunc is np.subtract:
                lhs, rhs = inputs
                if isinstance(lhs, ElectricalSignal):
                    return lhs.__sub__(rhs)
                if isinstance(rhs, ElectricalSignal):
                    return (-rhs).__add__(lhs)
            if ufunc is np.multiply:
                lhs, rhs = inputs
                if isinstance(lhs, ElectricalSignal):
                    return lhs.__mul__(rhs)
                if isinstance(rhs, ElectricalSignal):
                    return rhs.__mul__(lhs)
        new_inputs = [inp.__array__() if isinstance(inp, ElectricalSignal)
                      else inp for inp in inputs]
        return self._wrap_array_result(
            getattr(ufunc, method)(*new_inputs, **kwargs))

    def __array_function__(self, func, types, args, kwargs):
        """Higher-level NumPy functions (np.concatenate, np.convolve,
        np.fft.fft, ...) act on ``signal + noise`` and re-wrap
        shape-compatible results (reference typing.py:1278-1306)."""
        def _convert(obj):
            if isinstance(obj, ElectricalSignal):
                return obj.__array__()
            if isinstance(obj, (list, tuple)):
                return type(obj)(_convert(i) for i in obj)
            if isinstance(obj, dict):
                return {k: _convert(v) for k, v in obj.items()}
            return obj

        return self._wrap_array_result(
            func(*_convert(args), **_convert(kwargs)))

    # -- parsing helper --
    def _parse(self, other):
        if isinstance(other, ElectricalSignal):
            return other, True
        return self.__class__(_asarray(other)), False

    # -- arithmetic with noise propagation --
    def __add__(self, other):
        other, _ = self._parse(other)
        return self.__class__(self.signal + other.signal,
                              self.noise + other.noise)

    __radd__ = __add__

    def __neg__(self):
        return self.__class__(-self.signal, -self.noise)

    def __sub__(self, other):
        other, _ = self._parse(other)
        return self + (-other)

    def __rsub__(self, other):
        other, _ = self._parse(other)
        return (-self) + other

    def __mul__(self, other):
        other, _ = self._parse(other)
        sig = self.signal * other.signal
        noi = (self.signal * other.noise + self.noise * other.signal
               + self.noise * other.noise)
        return self.__class__(sig, noi)

    __rmul__ = __mul__

    def __truediv__(self, number):
        if not isinstance(number, ComplexNumber):
            raise TypeError(
                f"Can't divide {self.__class__.__name__} by type {type(number)}")
        if number == 0:
            raise ZeroDivisionError(
                f"Can't divide {self.__class__.__name__} by zero")
        return self.__class__(self.signal / number, self.noise / number)

    def __floordiv__(self, other):
        x = self / other
        noi = np.floor(x.noise) if _has_noise(x.noise) else NULL
        return self.__class__(np.floor(x.signal), noi)

    def __pow__(self, other):
        if not isinstance(other, RealNumber):
            raise TypeError(
                f"Can't exponentiate {self.__class__.__name__} by type {type(other)}")
        if other == 0:
            return self.__class__(np.ones_like(self.signal), NULL)
        if other == 1:
            return self.__class__(self.signal, self.noise)
        if other == 2:
            sig = self.signal ** 2
            noi = (2 * self.signal * self.noise + self.noise ** 2
                   if _has_noise(self.noise) else NULL)
            return self.__class__(sig, noi)
        return self.__class__((self.signal + self.noise) ** other, NULL)

    def __gt__(self, other):
        other, _ = self._parse(other)
        x_r = np.asarray(self.signal + self.noise).real
        x_l = np.asarray(other.signal + other.noise).real
        return BinarySequence(np.asarray(x_r > x_l).astype(np.uint8))

    def __lt__(self, other):
        other, _ = self._parse(other)
        x_r = np.asarray(self.signal + self.noise).real
        x_l = np.asarray(other.signal + other.noise).real
        return BinarySequence(np.asarray(x_r < x_l).astype(np.uint8))

    def __eq__(self, other):
        other, _ = self._parse(other)
        return (self.signal + self.noise) == (other.signal + other.noise)

    def __ne__(self, other):
        # the reference omits __ne__, so `a != b` raises upstream (ndarray
        # truthiness via object.__ne__); define the elementwise complement
        other, _ = self._parse(other)
        return (self.signal + self.noise) != (other.signal + other.noise)

    def __hash__(self):
        return id(self)

    def __getitem__(self, key):
        if isinstance(key, (slice, int, tuple, np.ndarray)):
            noi = self.noise[key] if _has_noise(self.noise) else NULL
            return self.__class__(self.signal[key], noi)
        raise TypeError(f"Invalid argument type {type(key)}")

    def __len__(self):
        return int(np.shape(self.signal)[-1])

    def __iter__(self):
        """Iterate over signal+noise samples (reference typing.py:1219-1221)."""
        return iter(np.asarray(self))

    # -- FFT domain switch (reference typing.py:1421-1462) --
    def __call__(self, domain: Literal["t", "w", "f"], shift: bool = False):
        import jax.numpy as jnp
        xp = jnp if isinstance(self.signal, jax.Array) else np
        if domain in ("w", "f"):
            sig = xp.fft.fft(self.signal, axis=-1)
            noi = xp.fft.fft(self.noise, axis=-1) if _has_noise(self.noise) else NULL
            if shift:
                sig = xp.fft.fftshift(sig, axes=-1)
                if _has_noise(noi):
                    noi = xp.fft.fftshift(noi, axes=-1)
        elif domain == "t":
            sig = xp.fft.ifft(self.signal, axis=-1)
            noi = xp.fft.ifft(self.noise, axis=-1) if _has_noise(self.noise) else NULL
            if shift:
                sig = xp.fft.ifftshift(sig, axes=-1)
                if _has_noise(noi):
                    noi = xp.fft.ifftshift(noi, axes=-1)
        else:
            raise ValueError(
                "`domain` must be one of the following values ('t', 'w', 'f')")
        return self.__class__(sig, noi)

    # -- properties --
    @property
    def index(self) -> np.ndarray:
        """Sample index vector 0..n-1 (reference typing.py:1466-1468)."""
        return np.arange(self.size)

    @property
    def size(self) -> int:
        return int(np.size(self.signal))

    @property
    def shape(self):
        return np.shape(self.signal)

    @property
    def ndim(self):
        return np.ndim(self.signal)

    @property
    def dtype(self):
        return np.asarray(self.signal).dtype if not isinstance(
            self.signal, jax.Array) else self.signal.dtype

    @property
    def real(self):
        """Real parts of signal and noise, wrapped (reference typing.py:1477)."""
        noi = self.noise.real if _has_noise(self.noise) else NULL
        return self.__class__(self.signal.real, noi)

    @property
    def imag(self):
        noi = self.noise.imag if _has_noise(self.noise) else NULL
        return self.__class__(self.signal.imag, noi)

    @property
    def type(self):
        return type(self)

    @property
    def sizeof(self) -> int:
        """Memory size of the object in bytes (reference typing.py:1494-1499)."""
        return _sizeof(self)

    @property
    def fs(self) -> float:
        return gv.fs

    @property
    def sps(self) -> int:
        return gv.sps

    @property
    def dt(self) -> float:
        return gv.dt

    @property
    def t(self) -> np.ndarray:
        return np.arange(np.shape(self.signal)[-1]) * gv.dt

    # -- spectra axes --
    def w(self, shift: bool = False) -> np.ndarray:
        w = np.fft.fftfreq(np.shape(self.signal)[-1], gv.dt) * 2 * np.pi
        return np.fft.fftshift(w) if shift else w

    def f(self, shift: bool = False) -> np.ndarray:
        return self.w(shift) / (2 * np.pi)

    # -- math --
    def conj(self):
        noi = self.noise.conj() if _has_noise(self.noise) else NULL
        return self.__class__(self.signal.conj(), noi)

    def sum(self, axis: Optional[int] = None):
        noi = self.noise.sum(axis=axis) if _has_noise(self.noise) else NULL
        return self.__class__(self.signal.sum(axis=axis), noi)

    def mean(self, axis: int = -1):
        return np.mean(self.to_numpy(), axis=axis)

    def std(self, axis: int = -1):
        return np.std(self.to_numpy(), axis=axis)

    def abs(self, of: Literal["signal", "noise", "all"] = "all"):
        if not isinstance(of, str):
            raise TypeError("`of` must be a string.")
        of = of.lower()
        if of == "signal":
            return np.abs(np.asarray(self.signal))
        if of == "noise":
            if not _has_noise(self.noise):
                return np.zeros_like(np.asarray(self.signal).real)
            return np.abs(np.asarray(self.noise))
        if of == "all":
            return np.abs(self.to_numpy())
        raise ValueError(
            '`of` must be one of the following values ("signal", "noise", "all")')

    def power(self, unit: Literal["W", "dBm"] = "W",
              of: Literal["signal", "noise", "all"] = "all"):
        p = np.mean(self.abs(of) ** 2, axis=-1)
        if unit == "W":
            return p
        if unit.lower() == "dbm":
            return dbm(p)
        raise ValueError(
            '`unit` must be one of the following values ("W", "dBm")')

    def normalize(self, by: Literal["power", "amplitude"] = "power"):
        if by == "power":
            return self / float(np.sum(self.power("W", "signal")) ** 0.5)
        if by == "amplitude":
            return self / float(np.max(self.abs("signal")))
        raise ValueError(
            '`by` must be one of the following values ("power", "amplitude")')

    def phase(self) -> np.ndarray:
        return np.unwrap(np.angle(self.to_numpy()))

    def apply(self, fn, *args, **kwargs):
        """Apply ``fn`` elementwise to signal (and noise if present)."""
        noi = fn(self.noise, *args, **kwargs) if _has_noise(self.noise) else NULL
        return self.__class__(fn(self.signal, *args, **kwargs), noi)

    def filter(self, h):
        """FIR filter via FFT convolution (mode='same'), applied to signal
        and noise (reference typing.py:1758-1780)."""
        from .ops.pulses import fft_convolve_same
        sig = fft_convolve_same(self.signal, h)
        noi = fft_convolve_same(self.noise, h) if _has_noise(self.noise) else NULL
        return self.__class__(sig, noi)

    # -- host-side plotting --
    def plot(self, fmt="-", n: Optional[int] = None, xlabel=None, ylabel=None,
             grid: bool = False, hold: bool = True, show: bool = False,
             **kwargs):  # pragma: no cover - host plotting
        import matplotlib.pyplot as plt
        n = n if n is not None else self.size
        t = gv.t[:n] if gv.t.size >= n else np.arange(n) * self.dt
        y = np.asarray(self.to_numpy()).real
        y = y[..., :n] if y.ndim == 1 else y[..., :n].T
        if not hold:
            plt.figure()
        plt.plot(t * 1e9, y, fmt, **kwargs)
        plt.xlabel(xlabel or "Time [ns]")
        plt.ylabel(ylabel or "Amplitude [V]")
        if grid:
            plt.grid(alpha=0.3)
        if kwargs.get("label"):
            plt.legend()
        if show:
            plt.show()
        return self

    def psd(self, fmt="-", kind: str = "linear", n: Optional[int] = None,
            hold: bool = True, grid: bool = True, show: bool = False,
            **kwargs):  # pragma: no cover - host plotting
        import matplotlib.pyplot as plt
        from .utils.analysis import get_psd
        x = np.asarray(self.to_numpy())
        x = x if x.ndim == 1 else x[0]
        f, p = get_psd(x[:n] if n else x, fs=gv.fs * 1e-9)
        if kind == "log":
            p = 10 * np.log10(np.maximum(p, 1e-30) / 1e-3)
        if not hold:
            plt.figure()
        plt.plot(f, p, fmt, **kwargs)
        plt.xlabel("Frequency [GHz]")
        plt.ylabel("PSD" + (" [dBm]" if kind == "log" else " [W]"))
        if grid:
            plt.grid(alpha=0.3)
        if show:
            plt.show()
        return self

    def plot_eye(self, **kwargs):  # pragma: no cover - host plotting
        from .devices import GET_EYE
        eye_obj = GET_EYE(self, **kwargs)
        eye_obj.plot()
        return eye_obj

    def grid(self, **kwargs):  # pragma: no cover - host plotting
        """Add a grid to the current plot, chainable (reference typing.py:2043-2059)."""
        import matplotlib.pyplot as plt
        kwargs.setdefault("alpha", 0.3)
        plt.grid(**kwargs)
        return self

    def legend(self, *args, **kwargs):  # pragma: no cover - host plotting
        """Add a legend to the current plot, chainable (reference typing.py:2061-2078)."""
        import matplotlib.pyplot as plt
        plt.legend(*args, **kwargs)
        return self

    def show(self):  # pragma: no cover
        import matplotlib.pyplot as plt
        plt.show()
        return self


# ---------------------------------------------------------------------------
# OpticalSignal (reference typing.py:2103-2427)
# ---------------------------------------------------------------------------
class OpticalSignal(ElectricalSignal):
    """Optical field envelope with 1 or 2 polarization modes.

    ``n_pol=1`` -> 1-D array of shape (n,);  ``n_pol=2`` -> (2, n) array.
    Construction normalization follows reference typing.py:2124-2196:
    a 1-D input with ``n_pol=2`` is *duplicated* into both polarizations.
    """

    def __init__(self, signal, noise=NULL, n_pol: Optional[int] = None,
                 dtype=None):
        if isinstance(signal, ElectricalSignal):
            sig, noi = signal.signal, signal.noise
            if _has_noise(noise):
                noi = noi + _asarray(noise, dtype)
        else:
            sig = _asarray(signal, dtype)
            noi = _asarray(noise, dtype) if _has_noise(noise) else NULL

        if np.ndim(sig) > 2 or (np.ndim(sig) > 1 and np.shape(sig)[0] > 2) \
                or np.size(sig) < 1:
            raise ValueError(
                f"Signal must be a scalar, 1D or 2D array for optical_signal,"
                f" invalid shape {np.shape(sig)}")
        if n_pol is not None and n_pol not in (1, 2):
            raise ValueError("n_pol must be either 1 or 2")

        def _dup(x):
            import jax.numpy as jnp
            xp = jnp if isinstance(x, jax.Array) else np
            return xp.stack([x, x])

        if np.ndim(sig) == 0:
            sig = np.asarray([sig]) if not isinstance(sig, jax.Array) else sig[None]
            if _has_noise(noi) and np.ndim(noi) == 0:
                noi = np.asarray([noi]) if not isinstance(noi, jax.Array) else noi[None]
            if n_pol == 2:
                sig = _dup(sig)
                if _has_noise(noi):
                    noi = _dup(noi)
            else:
                n_pol = 1
        elif np.ndim(sig) == 1:
            if n_pol == 2:
                sig = _dup(sig)
                if _has_noise(noi):
                    noi = _dup(noi) if np.ndim(noi) == 1 else noi
            else:
                n_pol = 1
        else:  # 2-D
            if np.shape(sig)[0] == 1:
                if n_pol is None or n_pol == 2:
                    sig = np.tile(np.asarray(sig), (2, 1))
                    if _has_noise(noi):
                        noi = np.tile(np.asarray(noi), (2, 1))
                    n_pol = 2
                else:
                    sig = sig[0]
                    if _has_noise(noi):
                        noi = noi[0]
            else:
                if n_pol == 1:
                    sig = sig[0]
                    if _has_noise(noi):
                        noi = noi[0]
                else:
                    n_pol = 2

        self.n_pol = int(n_pol or (2 if np.ndim(sig) == 2 else 1))
        super().__init__(sig, noi, dtype=dtype)

    def _parse(self, other):
        if isinstance(other, OpticalSignal):
            return other, True
        if isinstance(other, ElectricalSignal):
            return (OpticalSignal(other.signal, other.noise,
                                  n_pol=self.n_pol), True)
        return (OpticalSignal(_asarray(other), n_pol=None), False)

    def __gt__(self, other):
        raise TypeError("'>' not supported for optical_signal")

    def __lt__(self, other):
        raise TypeError("'<' not supported for optical_signal")

    def __getitem__(self, key):
        noi = self.noise[key] if _has_noise(self.noise) else NULL
        sig = self.signal[key]
        if self.n_pol == 2 and isinstance(key, int):
            return OpticalSignal(sig, noi, n_pol=1)
        return self.__class__(sig, noi, n_pol=self.n_pol)

    @property
    def size(self) -> int:
        return int(np.shape(self.signal)[-1])


# Reference-style lowercase aliases.
binary_sequence = BinarySequence
electrical_signal = ElectricalSignal
optical_signal = OpticalSignal


# ---------------------------------------------------------------------------
# pytree registration — signals flow through jit/vmap/shard_map
# ---------------------------------------------------------------------------
def _es_flatten(x: ElectricalSignal):
    if _has_noise(x.noise):
        return (x.signal, x.noise), True
    return (x.signal,), False


def _es_unflatten(has_noise, children):
    obj = ElectricalSignal.__new__(ElectricalSignal)
    obj.signal = children[0]
    obj.noise = children[1] if has_noise else NULL
    obj.execution_time = 0.0
    return obj


def _os_flatten(x: OpticalSignal):
    if _has_noise(x.noise):
        return (x.signal, x.noise), (True, x.n_pol)
    return (x.signal,), (False, x.n_pol)


def _os_unflatten(aux, children):
    has_noise, n_pol = aux
    obj = OpticalSignal.__new__(OpticalSignal)
    obj.signal = children[0]
    obj.noise = children[1] if has_noise else NULL
    obj.n_pol = n_pol
    obj.execution_time = 0.0
    return obj


jax.tree_util.register_pytree_node(ElectricalSignal, _es_flatten, _es_unflatten)
jax.tree_util.register_pytree_node(OpticalSignal, _os_flatten, _os_unflatten)
