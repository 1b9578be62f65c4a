"""SGP4 orbit propagator (near-Earth), vectorized over time.

Implements the public SGP4 model (Spacetrack Report #3 / Vallado's
"Revisiting Spacetrack Report #3" equations) for LEO satellites — the
reference vendors libpredict (C, src-core/libs/predict) for the same job.
Deep-space (SDP4) terms are not implemented; every LRPT/HRPT/APT target is
near-Earth (period < 225 min). Positions are TEME km; convert with
geo.geodetic.eci_to_ecef.

All propagation math is NumPy over an arbitrary tsince array, so geolocating
a whole pass (thousands of scanline timestamps) is one vectorized call.

A copy of satdump_tpu/geo/sgp4.py, its imports rewritten to the port.
"""

from __future__ import annotations

import numpy as np

from satdump_tpu_torch.geo.tle import TLE

# WGS-72 constants (the SGP4 standard set)
XKE = 0.0743669161331734132     # sqrt(mu) in (earth radii)^1.5 / min
RE = 6378.135                   # km
J2 = 1.082616e-3
J3 = -2.53881e-6
J4 = -1.65597e-6
CK2 = 0.5 * J2
CK4 = -0.375 * J4
A3OVK2 = -J3 / CK2
S0 = 78.0 / RE + 1.0            # s parameter default
QZMS2T = ((120.0 - 78.0) / RE) ** 4
X2O3 = 2.0 / 3.0
MIN_PER_DAY = 1440.0


class SGP4:
    def __init__(self, tle: TLE):
        self.tle = tle
        self._init(tle)

    def _init(self, t: TLE):
        no = t.mean_motion * 2.0 * np.pi / MIN_PER_DAY   # rad/min
        ecco = t.eccentricity
        inclo = np.radians(t.inclination)
        nodeo = np.radians(t.raan)
        argpo = np.radians(t.arg_perigee)
        mo = np.radians(t.mean_anomaly)
        bstar = t.bstar

        cosio = np.cos(inclo)
        cosio2 = cosio * cosio
        eosq = ecco * ecco
        betao2 = 1.0 - eosq
        betao = np.sqrt(betao2)

        # un-Kozai the mean motion
        ak = (XKE / no) ** X2O3
        d1 = 0.75 * J2 * (3.0 * cosio2 - 1.0) / (betao * betao2)
        del1 = d1 / (ak * ak)
        adel = ak * (1.0 - del1 * del1 - del1 * (1.0 / 3.0 + 134.0 * del1 * del1 / 81.0))
        del0 = d1 / (adel * adel)
        self.no = no / (1.0 + del0)                      # rad/min
        self.ao = (XKE / self.no) ** X2O3

        self.ecco, self.inclo = ecco, inclo
        self.nodeo, self.argpo, self.mo, self.bstar = nodeo, argpo, mo, bstar
        self.cosio, self.sinio = cosio, np.sin(inclo)

        rp = self.ao * (1.0 - ecco)                      # perigee radius, ER
        self.isimp = (rp < (220.0 / RE + 1.0))

        # s4 / qoms24 with low-perigee correction
        s4 = S0
        qoms24 = QZMS2T
        perige = (rp - 1.0) * RE
        if perige < 156.0:
            s4 = perige - 78.0 if perige >= 98.0 else 20.0
            qoms24 = ((120.0 - s4) / RE) ** 4
            s4 = s4 / RE + 1.0

        pinvsq = 1.0 / (self.ao * self.ao * betao2 * betao2)
        tsi = 1.0 / (self.ao - s4)
        self.eta = self.ao * ecco * tsi
        etasq = self.eta * self.eta
        eeta = ecco * self.eta
        psisq = abs(1.0 - etasq)
        coef = qoms24 * tsi ** 4
        coef1 = coef / psisq ** 3.5
        c2 = coef1 * self.no * (
            self.ao * (1.0 + 1.5 * etasq + eeta * (4.0 + etasq))
            + 0.375 * J2 * tsi / psisq * (3.0 * cosio2 - 1.0)
            * (8.0 + 3.0 * etasq * (8.0 + etasq)))
        self.c1 = bstar * c2
        self.c3 = 0.0
        if ecco > 1.0e-4:
            self.c3 = -2.0 * coef * tsi * A3OVK2 * self.no * self.sinio / ecco
        self.c4 = (2.0 * self.no * coef1 * self.ao * betao2 * (
            self.eta * (2.0 + 0.5 * etasq) + ecco * (0.5 + 2.0 * etasq)
            - J2 * tsi / (self.ao * psisq) * (
                -3.0 * (3.0 * cosio2 - 1.0) * (1.0 - 2.0 * eeta + etasq * (1.5 - 0.5 * eeta))
                + 0.75 * (1.0 - cosio2) * (2.0 * etasq - eeta * (1.0 + etasq))
                * np.cos(2.0 * argpo))))
        self.c5 = 2.0 * coef1 * self.ao * betao2 * (
            1.0 + 2.75 * (etasq + eeta) + eeta * etasq)

        theta2 = cosio2
        theta4 = theta2 * theta2
        temp1 = 1.5 * CK2 * pinvsq * self.no
        temp2 = 0.5 * temp1 * CK2 * pinvsq
        temp3 = -0.46875 * J4 * pinvsq * pinvsq * self.no
        self.mdot = (self.no + 0.5 * temp1 * betao * (3.0 * theta2 - 1.0)
                     + 0.0625 * temp2 * betao *
                     (13.0 - 78.0 * theta2 + 137.0 * theta4))
        self.argpdot = (-0.5 * temp1 * (1.0 - 5.0 * theta2)
                        + 0.0625 * temp2 * (7.0 - 114.0 * theta2 + 395.0 * theta4)
                        + temp3 * (3.0 - 36.0 * theta2 + 49.0 * theta4))
        xhdot1 = -temp1 * cosio
        self.nodedot = xhdot1 + (0.5 * temp2 * (4.0 - 19.0 * theta2)
                                 + 2.0 * temp3 * (3.0 - 7.0 * theta2)) * cosio
        self.omgcof = bstar * self.c3 * np.cos(argpo)
        self.xmcof = 0.0
        if ecco > 1.0e-4:
            self.xmcof = -X2O3 * coef * bstar / eeta
        self.nodecf = 3.5 * betao2 * xhdot1 * self.c1
        self.t2cof = 1.5 * self.c1
        # xlcof/aycof for long-period periodics
        self.xlcof = 0.125 * A3OVK2 * self.sinio * (3.0 + 5.0 * cosio) \
            / max(1.0 + cosio, 1.5e-12)
        self.aycof = 0.25 * A3OVK2 * self.sinio
        self.delmo = (1.0 + self.eta * np.cos(mo)) ** 3
        self.sinmo = np.sin(mo)
        self.x7thm1 = 7.0 * theta2 - 1.0

        if not self.isimp:
            c1sq = self.c1 * self.c1
            self.d2 = 4.0 * self.ao * tsi * c1sq
            temp = self.d2 * tsi * self.c1 / 3.0
            self.d3 = (17.0 * self.ao + s4) * temp
            self.d4 = 0.5 * temp * self.ao * tsi * (221.0 * self.ao + 31.0 * s4) * self.c1
            self.t3cof = self.d2 + 2.0 * c1sq
            self.t4cof = 0.25 * (3.0 * self.d3 + self.c1 * (12.0 * self.d2 + 10.0 * c1sq))
            self.t5cof = 0.2 * (3.0 * self.d4 + 12.0 * self.c1 * self.d3
                                + 6.0 * self.d2 * self.d2
                                + 15.0 * c1sq * (2.0 * self.d2 + c1sq))
        else:
            self.d2 = self.d3 = self.d4 = 0.0
            self.t3cof = self.t4cof = self.t5cof = 0.0

    # ------------------------------------------------------------------
    def propagate_tsince(self, tsince_min) -> np.ndarray:
        """tsince (minutes since TLE epoch, any shape) -> TEME position
        (..., 3) km."""
        t = np.asarray(tsince_min, np.float64)
        xmdf = self.mo + self.mdot * t
        argpdf = self.argpo + self.argpdot * t
        nodedf = self.nodeo + self.nodedot * t
        argpm = argpdf
        xmp = xmdf
        t2 = t * t
        nodem = nodedf + self.nodecf * t2
        tempa = 1.0 - self.c1 * t
        tempe = self.bstar * self.c4 * t
        templ = self.t2cof * t2
        if not self.isimp:
            delomg = self.omgcof * t
            delm = self.xmcof * ((1.0 + self.eta * np.cos(xmdf)) ** 3 - self.delmo)
            temp = delomg + delm
            xmp = xmdf + temp
            argpm = argpdf - temp
            t3 = t2 * t
            t4 = t3 * t
            tempa = tempa - self.d2 * t2 - self.d3 * t3 - self.d4 * t4
            tempe = tempe + self.bstar * self.c5 * (np.sin(xmp) - self.sinmo)
            templ = templ + self.t3cof * t3 + t4 * (self.t4cof + t * self.t5cof)

        a = self.ao * tempa ** 2
        e = self.ecco - tempe
        e = np.clip(e, 1e-6, 0.999999)
        xl = xmp + argpm + nodem + self.no * templ
        beta = np.sqrt(1.0 - e * e)
        n = XKE / a ** 1.5

        # long-period periodics
        axn = e * np.cos(argpm)
        temp = 1.0 / (a * beta * beta)
        xll = temp * self.xlcof * axn
        aynl = temp * self.aycof
        xlt = xl + xll
        ayn = e * np.sin(argpm) + aynl

        # Kepler solve for (E + omega)
        u = np.mod(xlt - nodem, 2.0 * np.pi)
        eo1 = u
        for _ in range(10):
            sineo1 = np.sin(eo1)
            coseo1 = np.cos(eo1)
            tem5 = (u - ayn * coseo1 + axn * sineo1 - eo1) / \
                   (1.0 - coseo1 * axn - sineo1 * ayn)
            tem5 = np.clip(tem5, -0.95, 0.95)
            eo1 = eo1 + tem5
        sineo1, coseo1 = np.sin(eo1), np.cos(eo1)

        # short-period preliminaries
        ecose = axn * coseo1 + ayn * sineo1
        esine = axn * sineo1 - ayn * coseo1
        el2 = axn * axn + ayn * ayn
        pl = a * (1.0 - el2)
        r = a * (1.0 - ecose)
        rdotl = np.sqrt(a) * esine / r
        rvdotl = np.sqrt(pl) / r
        betal = np.sqrt(1.0 - el2)
        temp = esine / (1.0 + betal)
        sinu = a / r * (sineo1 - ayn - axn * temp)
        cosu = a / r * (coseo1 - axn + ayn * temp)
        su = np.arctan2(sinu, cosu)
        sin2u = 2.0 * sinu * cosu
        cos2u = 2.0 * cosu * cosu - 1.0

        # short-period periodics
        temp = 1.0 / pl
        temp1 = CK2 * temp
        temp2 = temp1 * temp
        rk = r * (1.0 - 1.5 * temp2 * betal * (3.0 * self.cosio ** 2 - 1.0)) \
            + 0.5 * temp1 * (1.0 - self.cosio ** 2) * cos2u
        uk = su - 0.25 * temp2 * self.x7thm1 * sin2u
        nodek = nodem + 1.5 * temp2 * self.cosio * sin2u
        inck = self.inclo + 1.5 * temp2 * self.cosio * self.sinio * cos2u

        # orientation vectors -> position
        sinuk, cosuk = np.sin(uk), np.cos(uk)
        sinik, cosik = np.sin(inck), np.cos(inck)
        sinnok, cosnok = np.sin(nodek), np.cos(nodek)
        mx = -sinnok * cosik
        my = cosnok * cosik
        ux = mx * sinuk + cosnok * cosuk
        uy = my * sinuk + sinnok * cosuk
        uz = sinik * sinuk
        return np.stack([rk * ux, rk * uy, rk * uz], axis=-1) * RE

    def position_ecef(self, t_unix) -> np.ndarray:
        """Unix time(s) -> ECEF position (..., 3) km."""
        from satdump_tpu_torch.geo.geodetic import eci_to_ecef
        t = np.asarray(t_unix, np.float64)
        tsince = (t - self.tle.epoch_unix) / 60.0
        return eci_to_ecef(self.propagate_tsince(tsince), t)

    def subpoint(self, t_unix) -> np.ndarray:
        """Unix time(s) -> (lat_deg, lon_deg, alt_km) sub-satellite point."""
        from satdump_tpu_torch.geo.geodetic import ecef_to_lla
        return ecef_to_lla(self.position_ecef(t_unix))
