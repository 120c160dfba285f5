"""Dataset registry mirroring the paper's Table III at CPU-feasible scale.

The paper evaluates 16 graphs (0.5M-18M vertices, 5M-268M edges). This
container is CPU-only with limited RAM, so each dataset keeps the paper's
*shape* (degree distribution family, average degree, directedness) at a
reduced scale. Names keep the paper's initials with an `s` (scaled) suffix.
Real-world web/social graphs are emulated with R-MAT at matched average
degree plus a power-law exponent tweak — the workload-diversity phenomenon
the paper exploits (Fig. 2) is a function of the degree skew, which R-MAT
reproduces.
"""
from __future__ import annotations

from typing import Callable, Dict

from .formats import Graph
from .rmat import rmat, uniform_random

# name -> (factory, paper_counterpart, note)
_REGISTRY: Dict[str, tuple] = {}


def register(name: str, paper: str, note: str):
    def deco(fn: Callable[[], Graph]):
        _REGISTRY[name] = (fn, paper, note)
        return fn
    return deco


@register("r16s", "rmat-19-32 (R19)", "synthetic RMAT, deg 32")
def _r16s() -> Graph:
    return rmat(14, 32, seed=19, name="r16s")


@register("r18s", "rmat-21-32 (R21)", "synthetic RMAT, deg 32")
def _r18s() -> Graph:
    return rmat(15, 32, seed=21, name="r18s")


@register("r20s", "rmat-24-16 (R24)", "synthetic RMAT, deg 16")
def _r20s() -> Graph:
    return rmat(17, 16, seed=24, name="r20s")


@register("g17s", "graph500-scale23 (G23)", "graph500 RMAT, deg 56")
def _g17s() -> Graph:
    return rmat(13, 56, seed=23, name="g17s")


@register("ggs", "web-google (GG)", "web graph, deg 6")
def _ggs() -> Graph:
    return rmat(14, 6, seed=101, name="ggs")


@register("ams", "amazon-2008 (AM)", "social, deg 7")
def _ams() -> Graph:
    return rmat(14, 7, seed=102, name="ams")


@register("hds", "web-hudong (HD)", "web, deg 7")
def _hds() -> Graph:
    return rmat(15, 7, seed=103, name="hds")


@register("bbs", "web-baidu-baike (BB)", "web, deg 8")
def _bbs() -> Graph:
    return rmat(15, 8, seed=104, name="bbs")


@register("tcs", "wiki-topcats (TC)", "web, deg 16")
def _tcs() -> Graph:
    return rmat(14, 16, seed=105, name="tcs")


@register("pks", "pokec (PK)", "social, deg 19")
def _pks() -> Graph:
    return rmat(14, 19, seed=106, name="pks")


@register("ljs", "liveJournal (LJ)", "social, deg 14")
def _ljs() -> Graph:
    return rmat(15, 14, seed=107, name="ljs")


@register("hws", "hollywood-2009 (HW)", "collab, deg 53")
def _hws() -> Graph:
    return rmat(13, 53, seed=108, name="hws")


@register("ors", "orkut (OR)", "social, deg 38")
def _ors() -> Graph:
    return rmat(14, 38, seed=109, name="ors")


@register("unif16", "(control)", "uniform degree — no skew control")
def _unif16() -> Graph:
    return uniform_random(14, 16, seed=7, name="unif16")


def names() -> list:
    return list(_REGISTRY)


def info(name: str) -> dict:
    fn, paper, note = _REGISTRY[name]
    return {"name": name, "paper": paper, "note": note}


def load(name: str) -> Graph:
    fn, _, _ = _REGISTRY[name]
    return fn()
