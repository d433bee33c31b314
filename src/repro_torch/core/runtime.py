"""Runtime model — paper §4.2 eq. (8) and the baselines' adapted variants
(port of ``repro.core.runtime``).

Total runtime of p global rounds of CE-FedAvg:
    p * [ max_k qτC/c_k + qW/b_d2e + πW/b_e2e ]
where C = FLOPs per SGD step, c_k device speed (FLOP/s), W model bits,
b_d2e device→edge uplink, b_e2e edge↔edge backhaul.

Baselines (paper §6.1 adaptation):
  FedAvg      p * [ qτC/c + W/b_d2c ]               (cloud aggregation)
  Hier-FAvg   p * [ qτC/c + (q-1)W/b_d2e + W/b_d2c ]
  Local-Edge  p * [ qτC/c + qW/b_d2e ]              (no inter-cluster)
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

MBPS = 1e6  # bits/s


@dataclass(frozen=True)
class HardwareProfile:
    """Paper §6.1 defaults: iPhone X devices, 10 Mb/s uplink,
    50 Mb/s backhaul, 1 Mb/s device→cloud."""
    device_flops: float = 691.2e9        # c_k
    b_d2e: float = 10 * MBPS
    b_e2e: float = 50 * MBPS
    b_d2c: float = 1 * MBPS
    bytes_per_param: int = 4
    # depth>2 hierarchies: bandwidth of tier ℓ's links for ℓ >= 2
    # (b_tiers[0] = tier 2 / region, ...); empty falls back to b_e2e
    b_tiers: Tuple[float, ...] = ()

    def tier_bandwidth(self, level: int) -> float:
        """Link bandwidth of a ``TierMix(level)`` exchange: the backhaul
        ``b_e2e`` for tier 1 (and any tier without its own entry), the
        per-tier override ``b_tiers[level-2]`` above it."""
        if level <= 1 or level - 2 >= len(self.b_tiers):
            return self.b_e2e
        return self.b_tiers[level - 2]

    @staticmethod
    def h100(gpus_per_replica: int = 1) -> "HardwareProfile":
        """A replica that is a model-parallel group of NVIDIA H100 SXM5
        cards (``--model-parallel``), priced from NVIDIA's data sheet for
        "NVIDIA H100 80GB HBM3, 700 W" — datasheet figures, not
        measurements: 989 TFLOP/s dense bf16 a card (the figure the port's
        kernel bounds use), the "uplink" to the edge the cards' NVLink
        (900 GB/s a card), the edge backhaul and the cloud link one
        ConnectX-7 port a card (400 Gb/s). Parameters travel in bf16.
        The reference's ``tpu_v5e`` prices TPU chips, which the port does
        not run on."""
        return HardwareProfile(
            device_flops=989e12 * gpus_per_replica,
            b_d2e=900e9 * 8,        # NVLink 4: 900 GB/s a card
            b_e2e=400e9,            # ConnectX-7: 400 Gb/s a port
            b_d2c=400e9,
            bytes_per_param=2,
        )


@dataclass(frozen=True)
class WorkloadProfile:
    model_params: int                 # parameter count
    flops_per_step: float             # C: FLOPs of one SGD step (fwd+bwd)

    def model_bits(self, hw: HardwareProfile) -> float:
        """W in eq. (8): the parameter payload at the wire precision the
        hardware profile transmits (``hw.bytes_per_param``)."""
        return self.model_params * hw.bytes_per_param * 8.0


class RuntimeModel:
    """Eq. (8) wall-clock model, split into compute and communication.

    ``device_speeds`` (FLOP/s per device) makes the compute term the
    paper's max_k qτC/c_k straggler rule; ``compute_time`` also accepts a
    per-call subset of speeds so the event clock (core/clock.py) can charge
    only the devices participating in a given round."""

    def __init__(self, hw: HardwareProfile, wl: WorkloadProfile,
                 device_speeds: Optional[Sequence[float]] = None):
        self.hw = hw
        self.wl = wl
        self.speeds = list(device_speeds) if device_speeds else None

    def compute_time(self, steps: int,
                     speeds: Optional[Sequence[float]] = None) -> float:
        """max_k steps·C/c_k — the slowest (participating) device paces
        every aggregation boundary."""
        if speeds is not None and len(speeds):
            slowest = min(speeds)
        elif self.speeds:
            slowest = min(self.speeds)
        else:
            slowest = self.hw.device_flops
        return steps * self.wl.flops_per_step / slowest

    def comm_time(self, algorithm: str, q: int, pi: int,
                  uplink_ratio: float = 1.0) -> float:
        """Communication terms of one global round under eq. (8).

        ``uplink_ratio`` scales the device→edge payload (compression,
        core.compress.compression_ratio)."""
        W = self.wl.model_bits(self.hw)
        Wu = W * uplink_ratio
        hw = self.hw
        if algorithm == "ce_fedavg":
            return q * Wu / hw.b_d2e + pi * W / hw.b_e2e
        if algorithm == "hier_favg":
            return (q - 1) * Wu / hw.b_d2e + W / hw.b_d2c
        if algorithm == "fedavg":
            return Wu / hw.b_d2c
        if algorithm == "local_edge":
            return q * Wu / hw.b_d2e
        if algorithm == "dec_local_sgd":
            return pi * W / hw.b_e2e
        raise ValueError(algorithm)

    def round_time(self, algorithm: str, tau: int, q: int, pi: int,
                   uplink_ratio: float = 1.0,
                   speeds: Optional[Sequence[float]] = None) -> float:
        """Wall time of ONE global round (qτ local steps) under eq. (8)."""
        return (self.compute_time(q * tau, speeds)
                + self.comm_time(algorithm, q, pi, uplink_ratio))

    def total_time(self, algorithm: str, rounds: int, tau: int, q: int,
                   pi: int, uplink_ratio: float = 1.0) -> float:
        return rounds * self.round_time(algorithm, tau, q, pi, uplink_ratio)


def paper_runtime_model(
        device_speeds: Optional[Sequence[float]] = None) -> RuntimeModel:
    """The §6.1 reference runtime: iPhone-class devices over 10/50/1 Mb/s
    links carrying the FEMNIST CNN (6,603,710 params; C = 13.3 MFLOPs ×
    batch 50 × fwd+bwd factor 3). The single source for the constants the
    quickstart, the time-to-accuracy CLI and the benchmarks all price
    against."""
    return RuntimeModel(HardwareProfile(),
                        WorkloadProfile(6_603_710, 13.30e6 * 50 * 3),
                        device_speeds)


def compute_bound_runtime_model(
        device_speeds: Optional[Sequence[float]] = None) -> RuntimeModel:
    """A compute-dominated counterpart to :func:`paper_runtime_model`:
    microcontroller-class devices (100 MFLOP/s — two to three orders
    below the §6.1 iPhone) behind LAN-class links (50/200/10 Mb/s), the
    on-premise federated-edge regime where local training, not the
    uplink, paces the round. This is the profile under which schedule
    adaptations of the *compute* term (adaptive per-cluster τ_k,
    ``core.program.make_schedule("adaptive_tau", ...)``) move wall-clock
    time-to-accuracy; under the paper's uplink-bound §6.1 constants the
    compute term is milliseconds against minutes of communication."""
    return RuntimeModel(
        HardwareProfile(device_flops=0.1e9, b_d2e=50 * MBPS,
                        b_e2e=200 * MBPS, b_d2c=10 * MBPS),
        WorkloadProfile(6_603_710, 13.30e6 * 50 * 3),
        device_speeds)


def gossip_traffic_per_round(impl: str, *, num_clusters: int,
                             devices_per_cluster: int, pi: int,
                             degrees: Sequence[int],
                             model_bits: float) -> Dict[str, float]:
    """Inter-cluster aggregation traffic of one global round, in bits.

    Per-replica received bits (the latency-relevant number) and total
    network bits, by ``gossip_impl`` backend:

      dense      (R−1)·W   per replica — the (R,R)·(R,…) contraction
                 all-gathers every other replica's model
      sparse     π·deg(c)·W per replica (max over clusters reported) — π
                 gossip rounds, each receiving one model per backhaul edge
      ringweight (M−1)·W   per replica — M−1 weighted cyclic rotations

    ``degrees`` are the backhaul degrees deg(c) of the M clusters.
    """
    M, dpc = num_clusters, devices_per_cluster
    R = M * dpc
    W = float(model_bits)
    deg = list(degrees)
    assert len(deg) == M, (len(deg), M)
    if M == 1:
        return {"per_replica_bits": 0.0, "total_bits": 0.0}
    if impl == "dense":
        per, tot = (R - 1) * W, R * (R - 1) * W
    elif impl == "sparse":
        per, tot = pi * max(deg) * W, pi * sum(deg) * dpc * W
    elif impl == "ringweight":
        per, tot = (M - 1) * W, R * (M - 1) * W
    else:
        raise ValueError(impl)
    return {"per_replica_bits": per, "total_bits": tot}


def convergence_bound(T: int, eta: float, L: float, sigma2: float,
                      eps2: float, eps_i2: float, n: int, m: int,
                      tau: int, q: int, z: float, pi: int,
                      f_gap: float = 1.0) -> float:
    """Theorem 1 RHS (eq. 23) — used to sanity-check parameter effects."""
    from repro_torch.core.topology import omega1, omega2
    o1, o2 = omega1(z, pi), omega2(z, pi)
    t1 = 2 * f_gap / (eta * T)
    t2 = eta * L * sigma2 / n
    t3 = 8 * eta**2 * L**2 * (o1 * q * tau + (m - 1) / n * q * tau) * sigma2
    t4 = 16 * eta**2 * L**2 * q**2 * tau**2 * o2 * eps2
    t5 = 8 * (n - m) / n * eta**2 * L**2 * tau * sigma2
    t6 = 16 * L**2 * eta**2 * tau**2 * eps_i2
    return t1 + t2 + t3 + t4 + t5 + t6
