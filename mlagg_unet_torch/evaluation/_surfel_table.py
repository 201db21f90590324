"""Marching-cubes surfel-normal lookup table (256 neighbour codes).

For every 2x2x2-neighbourhood binary code this table holds the surface
normals of the marching-cubes triangles ("surfels") of that cell; the
vector length encodes the surfel area at unit spacing. This is the
canonical DeepMind surface-distance table (public, Apache-2.0; created by
the Medical Decathlon's compute_surface_area_lookup_table.ipynb) that the
reference evaluation suite embeds as a 256-entry nested float literal
(its evaluation/SurfaceDice.py:21-277). Metric exactness —
NSD parity with every published MLAgg-UNet table — requires these exact
values, so they are shipped here re-encoded: all components are multiples
of 1/8, stored as an int8 (256, 4, 3) array (codes x max-4 triangles x
xyz, zero-padded; zero rows contribute zero area) and zlib+base85 packed.

Copied from ``mlagg_unet_tpu/evaluation/_surfel_table.py`` with the imports rewritten.
"""
from __future__ import annotations

import base64
import zlib

import numpy as np

_PACKED = (
    "c-nQA3zEbj2t)(P{ZE|e@=<(ovRhMI1{JY|rjKL&iAarmU*pye)wzcDqv@e#uPxVM>ovV~_%"
    "us>n#(r#UVen;c8!VU$L!K=eA^n;+<wJxp4*SFK+W5lx>r0x`*EAS$7ie`Q)X!vP;BXf_2EB"
    "b$oO;0mYnBl@uj7%;6`okO+Ef}Yl~~V;VE(6JWCf4w@r1`HshDVd_6&|&#C9Jb1nF8vmHLu|"
    "9paLVQwhfUJE^(SNw&)d(d`1kIie`h40m7ZrBEMG~l`-ymEApCAoga`Pfm3kH5}sZXK>Qi2P"
    "YcTpntVOnc79@auj@EqnRTE428f-TdcgK4WVic^*$KW#@QhmU+j84W9vT*mKKi_*?w`WZ_4I"
    "{`1p)&Jw8n_wA11ct;!9FU<awhQFti$aP?i$JHvHs*&`cQ?~ax&wxuJ=i9v6sw9a&^-EqgDF"
    "2l+d0&~q=d9<95Bx6n-_oyX0=w{WpIB48(fcbu>(jSa3C#Q-#=;!&jCUDt?<dI2pQ5H32Nhg"
    "}dDcbcZDJdhFN;PZ0|tkH6QV|1ekS-?0%z3V$j^Immx1GVQq4?g6KD4vVMmc@@mO)Gyn-Lxi"
    "+F?-SoY4^M;?B1{<fz7<8z(G7!Vs{=3V&7yAu;)MGT28F_#~H=G{Nv6fI!o0CR&m!(19bj4S"
    "N9H()`oGKaU^E(}=<tP$1@Yl^j&_|MN*ZC1^)mRaNPF1k2@TtN;Yw~%w*T(mff+(k|!*O3D^"
    "ZY<6umy%<Dx%Zc=$>AHfQ!-R9`0Wt`li5lVxx(tR2W9Z9XQ7v|$FcXZC$d*=J+yi&doFu1do"
    "+7DdpdhPH2}2%H3PK-H3qc@H3_u}H4J%!nul758j0G8nu=PB8jRYEn(d|KI%|JvKlw*1zBDA"
    "XB{k=(iryNvwCkp63v+5<YGZ0<YH4chO?!W8^-bFxUw?n^>=C*"
)


def _decode() -> np.ndarray:
    raw = zlib.decompress(base64.b85decode(_PACKED))
    arr = np.frombuffer(raw, np.int8).reshape(256, 4, 3)
    return arr.astype(np.float64) / 8.0


#: (256, 4, 3) float64 — triangle normal vectors per neighbour code at unit
#: spacing; padded triangles are all-zero.
NEIGHBOUR_CODE_NORMALS: np.ndarray = _decode()
