"""Grid projections: lat/lon of the model grid from its map projection
(port of ``pism_tpu/util/projection.py``, numpy code, used when files are
read and written).

PISM (``src/util/projection.cc``) computes the mandatory ``lat``/``lon``
fields with PROJ from the input's CF grid mapping or ``proj`` attribute
(``grid.recompute_longitude_and_latitude``). Without PROJ, the two
projections ice-sheet datasets use are implemented from Snyder (1987, "Map
Projections - A Working Manual"): ellipsoidal polar stereographic (eqs.
21-33..21-41, EPSG:3413 Greenland, EPSG:3031 Antarctica) and transverse
Mercator (eqs. 8-9..8-25, UTM zones).

Inputs: a PROJ.4-style string (``+proj=stere +lat_0=90 +lat_ts=70
+lon_0=-45 ...``, ``+proj=tmerc``, ``+proj=utm +zone=N``) or a CF
grid-mapping attribute dict.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

#: WGS84
A_WGS84 = 6378137.0
E_WGS84 = 0.0818191908426215


def _t_snyder(phi, e):
    """Snyder's t(phi) = tan(pi/4 - phi/2) / ((1 - e sin phi)/(1 + e sin
    phi))^(e/2), eq. 15-9."""
    es = e * np.sin(phi)
    return np.tan(np.pi / 4.0 - phi / 2.0) / ((1.0 - es) / (1.0 + es)) ** (e / 2.0)


def _m_snyder(phi, e):
    """m(phi) = cos phi / sqrt(1 - e^2 sin^2 phi), eq. 14-15."""
    return np.cos(phi) / np.sqrt(1.0 - (e * np.sin(phi)) ** 2)


@dataclass(frozen=True)
class PolarStereographic:
    """Ellipsoidal polar stereographic with a standard parallel.

    ``standard_parallel`` and the hemisphere sign follow the CF/EPSG
    conventions: positive for the north grids (EPSG:3413 has 70),
    negative for the south (EPSG:3031 has -71).
    """

    central_meridian: float = -45.0     # lon_0 [degrees]
    standard_parallel: float = 70.0     # lat_ts [degrees]
    false_easting: float = 0.0
    false_northing: float = 0.0
    a: float = A_WGS84
    e: float = E_WGS84

    @property
    def _south(self) -> bool:
        return self.standard_parallel < 0.0

    def _consts(self):
        s = -1.0 if self._south else 1.0
        phi_ts = np.deg2rad(abs(self.standard_parallel))
        # rho(phi) = a m(phi_ts) t(phi)/t(phi_ts)  (Snyder 21-34)
        scale = self.a * _m_snyder(phi_ts, self.e) / _t_snyder(phi_ts, self.e)
        return s, scale

    def forward(self, lat, lon):
        """(lat, lon) degrees -> (x, y) meters."""
        lat = np.asarray(lat, float)
        lon = np.asarray(lon, float)
        s, scale = self._consts()
        t = _t_snyder(np.deg2rad(s * lat), self.e)
        rho = scale * t
        dlam = np.deg2rad(s * (lon - self.central_meridian))
        x = s * rho * np.sin(dlam) + self.false_easting
        y = -s * rho * np.cos(dlam) + self.false_northing
        return x, y

    def inverse(self, x, y):
        """(x, y) meters -> (lat, lon) degrees."""
        x = np.asarray(x, float) - self.false_easting
        y = np.asarray(y, float) - self.false_northing
        s, scale = self._consts()
        xs, ys = s * x, s * y
        rho = np.hypot(xs, ys)
        t = rho / scale
        # iterate phi = pi/2 - 2 atan(t ((1 - e sin phi)/(1 + e sin
        # phi))^(e/2))  (Snyder 7-9); converges in a few rounds
        phi = np.pi / 2.0 - 2.0 * np.arctan(t)
        for _ in range(6):
            es = self.e * np.sin(phi)
            phi = np.pi / 2.0 - 2.0 * np.arctan(
                t * ((1.0 - es) / (1.0 + es)) ** (self.e / 2.0))
        lam = np.deg2rad(self.central_meridian) + np.arctan2(xs, -ys)
        lat = s * np.rad2deg(phi)
        lon = s * (np.rad2deg(lam) - self.central_meridian) \
            + self.central_meridian
        lon = (lon + 180.0) % 360.0 - 180.0
        # the exact pole has undefined longitude; pin it to the central
        # meridian for a deterministic field
        lat = np.where(rho == 0.0, s * 90.0, lat)
        return lat, lon


def from_proj_string(proj: str):
    """Parse a PROJ.4-style string (the reference stores one in the
    ``proj`` global attribute of its output files): ``+proj=stere``
    (polar), ``+proj=tmerc`` or ``+proj=utm +zone=N``."""
    kv = {}
    for tok in str(proj).split():
        tok = tok.lstrip("+")
        if "=" in tok:
            k, v = tok.split("=", 1)
            kv[k] = v
        elif tok:
            kv[tok] = True
    p = kv.get("proj")
    if p == "utm":
        zone = int(kv.get("zone", 0))
        if not 1 <= zone <= 60:
            raise ValueError(f"utm needs +zone=1..60, got {zone}")
        return TransverseMercator(
            central_meridian=-183.0 + 6.0 * zone,
            false_northing=1.0e7 if "south" in kv else 0.0)
    if p == "tmerc":
        return TransverseMercator(
            central_meridian=float(kv.get("lon_0", 0.0)),
            latitude_origin=float(kv.get("lat_0", 0.0)),
            scale_factor=float(kv.get("k", kv.get("k_0", 1.0))),
            false_easting=float(kv.get("x_0", 0.0)),
            false_northing=float(kv.get("y_0", 0.0)))
    if p not in ("stere", "sterea"):
        raise ValueError(f"unsupported projection {p!r} "
                         "(stere, tmerc and utm are implemented)")
    lat_0 = float(kv.get("lat_0", 90.0))
    lat_ts = float(kv.get("lat_ts", lat_0))
    if abs(lat_0) != 90.0:
        raise ValueError("only the polar aspect (lat_0 = +-90) is supported")
    return PolarStereographic(
        central_meridian=float(kv.get("lon_0", 0.0)),
        standard_parallel=lat_ts if lat_0 > 0 else -abs(lat_ts),
        false_easting=float(kv.get("x_0", 0.0)),
        false_northing=float(kv.get("y_0", 0.0)))


def from_cf_mapping(attrs):
    """Build from CF grid-mapping attributes (``polar_stereographic`` or
    ``transverse_mercator``)."""
    def get(name, default=None):
        v = attrs.get(name, default)
        if isinstance(v, bytes):
            v = v.decode()
        if isinstance(v, (list, tuple, np.ndarray)):
            v = np.asarray(v).ravel()[0]
        return v

    name = get("grid_mapping_name", "polar_stereographic")
    if name == "transverse_mercator":
        return TransverseMercator(
            central_meridian=float(get("longitude_of_central_meridian",
                                       0.0)),
            latitude_origin=float(get("latitude_of_projection_origin",
                                      0.0)),
            scale_factor=float(get("scale_factor_at_central_meridian",
                                   1.0)),
            false_easting=float(get("false_easting", 0.0)),
            false_northing=float(get("false_northing", 0.0)))
    if name != "polar_stereographic":
        raise ValueError(f"unsupported grid mapping {name!r}")
    lat0 = float(get("latitude_of_projection_origin", 90.0))
    ts = get("standard_parallel",
             get("scale_factor_at_projection_origin"))
    if ts is None:
        ts = lat0
    ts = float(ts)
    return PolarStereographic(
        central_meridian=float(
            get("straight_vertical_longitude_from_pole",
                get("longitude_of_projection_origin", 0.0))),
        standard_parallel=ts if lat0 > 0 else -abs(ts),
        false_easting=float(get("false_easting", 0.0)),
        false_northing=float(get("false_northing", 0.0)))


def lonlat_for_grid(grid, ps: PolarStereographic):
    """(lon, lat) 2D fields [degrees] for the grid's cell centers."""
    X, Y = np.meshgrid(grid.x, grid.y)
    lat, lon = ps.inverse(X, Y)
    return lon, lat


@dataclass(frozen=True)
class TransverseMercator:
    """Ellipsoidal transverse Mercator (Snyder 1987 eqs. 8-9..8-25), the
    non-polar CRS of regional glacier setups (UTM zones; PROJ
    ``+proj=tmerc`` / ``+proj=utm``). Series forms, sub-meter accurate
    within ~10 degrees of the central meridian — far beyond any regional
    model domain."""

    central_meridian: float = 0.0    # lon_0 [deg]
    latitude_origin: float = 0.0     # lat_0 [deg]
    scale_factor: float = 0.9996     # k_0 (UTM default)
    false_easting: float = 500000.0
    false_northing: float = 0.0
    a: float = A_WGS84
    e: float = E_WGS84

    def _M(self, phi):
        """Meridional arc length (Snyder 3-21)."""
        e2 = self.e ** 2
        e4, e6 = e2 ** 2, e2 ** 3
        return self.a * (
            (1 - e2 / 4 - 3 * e4 / 64 - 5 * e6 / 256) * phi
            - (3 * e2 / 8 + 3 * e4 / 32 + 45 * e6 / 1024) * np.sin(2 * phi)
            + (15 * e4 / 256 + 45 * e6 / 1024) * np.sin(4 * phi)
            - (35 * e6 / 3072) * np.sin(6 * phi))

    def forward(self, lat, lon):
        """(lat, lon) degrees -> (x, y) meters."""
        phi = np.deg2rad(np.asarray(lat, float))
        lam = np.deg2rad(np.asarray(lon, float))
        lam0 = np.deg2rad(self.central_meridian)
        e2 = self.e ** 2
        ep2 = e2 / (1 - e2)
        N = self.a / np.sqrt(1 - e2 * np.sin(phi) ** 2)
        T = np.tan(phi) ** 2
        C = ep2 * np.cos(phi) ** 2
        A_ = (lam - lam0) * np.cos(phi)
        M = self._M(phi)
        M0 = self._M(np.deg2rad(self.latitude_origin))
        k0 = self.scale_factor
        x = k0 * N * (A_ + (1 - T + C) * A_ ** 3 / 6
                      + (5 - 18 * T + T ** 2 + 72 * C - 58 * ep2)
                      * A_ ** 5 / 120) + self.false_easting
        y = k0 * (M - M0 + N * np.tan(phi) * (
            A_ ** 2 / 2 + (5 - T + 9 * C + 4 * C ** 2) * A_ ** 4 / 24
            + (61 - 58 * T + T ** 2 + 600 * C - 330 * ep2)
            * A_ ** 6 / 720)) + self.false_northing
        return x, y

    def inverse(self, x, y):
        """(x, y) meters -> (lat, lon) degrees."""
        e2 = self.e ** 2
        ep2 = e2 / (1 - e2)
        k0 = self.scale_factor
        M0 = self._M(np.deg2rad(self.latitude_origin))
        M = M0 + (np.asarray(y, float) - self.false_northing) / k0
        mu = M / (self.a * (1 - e2 / 4 - 3 * e2 ** 2 / 64
                            - 5 * e2 ** 3 / 256))
        e1 = (1 - np.sqrt(1 - e2)) / (1 + np.sqrt(1 - e2))
        phi1 = (mu + (3 * e1 / 2 - 27 * e1 ** 3 / 32) * np.sin(2 * mu)
                + (21 * e1 ** 2 / 16 - 55 * e1 ** 4 / 32) * np.sin(4 * mu)
                + (151 * e1 ** 3 / 96) * np.sin(6 * mu)
                + (1097 * e1 ** 4 / 512) * np.sin(8 * mu))
        C1 = ep2 * np.cos(phi1) ** 2
        T1 = np.tan(phi1) ** 2
        N1 = self.a / np.sqrt(1 - e2 * np.sin(phi1) ** 2)
        R1 = self.a * (1 - e2) / (1 - e2 * np.sin(phi1) ** 2) ** 1.5
        D = (np.asarray(x, float) - self.false_easting) / (N1 * k0)
        phi = phi1 - (N1 * np.tan(phi1) / R1) * (
            D ** 2 / 2
            - (5 + 3 * T1 + 10 * C1 - 4 * C1 ** 2 - 9 * ep2) * D ** 4 / 24
            + (61 + 90 * T1 + 298 * C1 + 45 * T1 ** 2 - 252 * ep2
               - 3 * C1 ** 2) * D ** 6 / 720)
        lam = np.deg2rad(self.central_meridian) + (
            D - (1 + 2 * T1 + C1) * D ** 3 / 6
            + (5 - 2 * C1 + 28 * T1 - 3 * C1 ** 2 + 8 * ep2
               + 24 * T1 ** 2) * D ** 5 / 120) / np.cos(phi1)
        return np.rad2deg(phi), np.rad2deg(lam)

    def cf_mapping(self):
        return {
            "grid_mapping_name": "transverse_mercator",
            "longitude_of_central_meridian": self.central_meridian,
            "latitude_of_projection_origin": self.latitude_origin,
            "scale_factor_at_central_meridian": self.scale_factor,
            "false_easting": self.false_easting,
            "false_northing": self.false_northing,
        }

    def proj_string(self):
        return (f"+proj=tmerc +lat_0={self.latitude_origin:g} "
                f"+lon_0={self.central_meridian:g} "
                f"+k={self.scale_factor:g} +x_0={self.false_easting:g} "
                f"+y_0={self.false_northing:g} +datum=WGS84")


def lonlat_bounds_for_grid(grid, ps):
    """CF ``lon_bnds``/``lat_bnds`` (My, Mx, 4) cell-corner fields
    [degrees] for the grid (reference ``src/util/projection.cc``
    ``compute_cell_bounds`` role); counterclockwise corner order
    (SW, SE, NE, NW)."""
    dx2, dy2 = grid.dx / 2.0, grid.dy / 2.0
    X, Y = np.meshgrid(grid.x, grid.y)
    lon_b = np.empty(X.shape + (4,))
    lat_b = np.empty(X.shape + (4,))
    for k, (sx, sy) in enumerate(((-1, -1), (1, -1), (1, 1), (-1, 1))):
        lat, lon = ps.inverse(X + sx * dx2, Y + sy * dy2)
        lon_b[..., k] = lon
        lat_b[..., k] = lat
    return lon_b, lat_b
