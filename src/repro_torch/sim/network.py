"""Link model — the paper's Table 3, verbatim.

Edge setting: Cli-St 5 ms/100 Mbps; St-St 2 ms/1000 Mbps;
St-Gw 2 ms/750 Mbps; Gw-Gw 10 ms/500 Mbps.
Cloud setting: Cli-St 50 ms/100 Mbps; all internal links 0.05 ms/1000 Mbps.

Transfer time = propagation latency + serialization (bytes / bandwidth).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict


@dataclass(frozen=True)
class Link:
    latency_s: float
    bandwidth_bps: float

    def xfer(self, nbytes: float) -> float:
        return self.latency_s + (8.0 * nbytes) / self.bandwidth_bps


def _ms(x: float) -> float:
    return x * 1e-3


def _mbps(x: float) -> float:
    return x * 1e6


class NetworkModel:
    KINDS = ("cli_st", "st_st", "st_gw", "gw_gw")

    def __init__(self, links: Dict[str, Link]):
        missing = set(self.KINDS) - set(links)
        if missing:
            raise ValueError(f"missing link kinds: {sorted(missing)}")
        self.links = links

    def xfer(self, kind: str, nbytes: float) -> float:
        return self.links[kind].xfer(nbytes)


EDGE_SETTING = NetworkModel({
    "cli_st": Link(_ms(5), _mbps(100)),
    "st_st": Link(_ms(2), _mbps(1000)),
    "st_gw": Link(_ms(2), _mbps(750)),
    "gw_gw": Link(_ms(10), _mbps(500)),
})

CLOUD_SETTING = NetworkModel({
    "cli_st": Link(_ms(50), _mbps(100)),
    "st_st": Link(_ms(0.05), _mbps(1000)),
    "st_gw": Link(_ms(0.05), _mbps(1000)),
    "gw_gw": Link(_ms(0.05), _mbps(1000)),
})

SETTINGS = {"edge": EDGE_SETTING, "cloud": CLOUD_SETTING}
