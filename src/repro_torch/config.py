"""Configuration of the port: the paper's federated-learning knobs and
the language models' shapes.

Port of ``repro.config``'s :class:`FLConfig`, of its scenario, fault
and virtual-population configs, of :class:`ModelConfig`, and of the
LM trainer's :class:`MeshConfig`, :class:`ShapeConfig`,
:class:`TrainConfig` and :class:`ExperimentConfig` (plain dataclasses,
no external deps).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Tuple

# ---------------------------------------------------------------------------
# Model
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm", "cnn")


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # one of FAMILIES
    num_layers: int
    d_model: int
    num_heads: int = 0            # 0 for attention-free archs
    num_kv_heads: int = 0
    d_ff: int = 0
    vocab_size: int = 0
    head_dim: int = 0             # 0 -> d_model // num_heads
    qkv_bias: bool = False
    mlp_act: str = "silu"         # silu | gelu | relu2 (nemotron squared relu)
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    rope_theta: float = 10000.0
    use_rope: bool = True         # whisper uses learned positions instead
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    capacity_factor: float = 1.25
    moe_shared_expert: bool = False   # llama4 has a shared expert
    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    ssm_conv_width: int = 4
    # --- hybrid (Zamba2-style): one *shared* attention block every k SSM blocks
    attn_every: int = 0
    # --- attention locality ---
    sliding_window: int = 0       # 0 = full attention
    # --- encoder/decoder (Whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 1500       # stub audio frontend: #frames after conv
    # --- VLM (Pixtral): stub vision frontend
    num_patches: int = 0          # patch embeddings prepended to text
    # --- beyond-paper performance knobs ---
    attn_seq_shard: bool = False   # context-parallel attention core in the
    #   reference's sharded runs; kept so configs carry across, unused on
    #   the port's one device
    moe_local_dispatch: bool = False  # MoE dispatch within each batch row
    head_pad_to: int = 0           # pad query heads to this count with
    #   zero-masked (permanently inert) heads; mathematically identical
    #   outputs, ~heads_pad/heads extra attention FLOPs
    # --- numerics ---
    dtype: str = "bfloat16"
    param_dtype: str = "bfloat16"
    # --- citation (model card / arXiv that fixes the shape) ---
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.num_heads, 1)

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic serve path exists (SSM state or sliding window)."""
        return self.family in ("ssm", "hybrid") or self.sliding_window > 0

    def reduced(self, **overrides) -> "ModelConfig":
        """A smoke-test-sized variant of the same family (<=2 layers etc.)."""
        small = dict(
            num_layers=2,
            d_model=min(self.d_model, 256),
            num_heads=min(self.num_heads, 4) if self.num_heads else 0,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            head_dim=64 if self.num_heads else 0,
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            experts_per_token=min(self.experts_per_token, 2)
            if self.experts_per_token else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_chunk=64 if self.ssm_state else 256,
            encoder_layers=2 if self.encoder_layers else 0,
            encoder_seq=32 if self.encoder_layers else 1500,
            num_patches=8 if self.num_patches else 0,
            attn_every=2 if self.attn_every else 0,
            sliding_window=min(self.sliding_window, 64)
            if self.sliding_window else 0,
            dtype="float32",
            param_dtype="float32",
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)


# ---------------------------------------------------------------------------
# Federated learning (the paper's knobs)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class FLConfig:
    algorithm: str = "ce_fedavg"   # ce_fedavg | fedavg | hier_favg | local_edge | dec_local_sgd
    num_clusters: int = 4          # m
    devices_per_cluster: int = 4   # n_i (equal clusters by default)
    tau: int = 2                   # intra-cluster aggregation period
    q: int = 8                     # edge rounds per global round
    pi: int = 10                   # gossip steps per inter-cluster aggregation
    topology: str = "ring"         # ring | complete | star | torus | erdos_renyi
    er_prob: float = 0.4           # for erdos_renyi
    topology_seed: int = 0
    mixing: str = "metropolis"     # metropolis | uniform_neighbor
    # sharded-trainer mapping; all three backends support every topology:
    #   dense      paper-faithful (R,R)·(R,…) contraction (all-gather)
    #   sparse     π gossip rounds of weighted neighbor ppermute matchings
    #   ringweight exact H^π in M−1 weighted cyclic rotations
    gossip_impl: str = "dense"
    cluster_axis: str = "data"     # mesh axis along which replicas/clusters live
    # depth>2 hierarchies: branching factors root→leaf, e.g. (2, 2, 2) =
    # 2 regions × 2 edges × 2 devices. () keeps the paper's two tiers
    # (num_clusters, devices_per_cluster). When set, the last entry must
    # equal devices_per_cluster and the product of the rest num_clusters,
    # so the depth-2 projection of the hierarchy IS the existing config.
    hierarchy: Tuple[int, ...] = ()

    GOSSIP_IMPLS = ("dense", "sparse", "ringweight")

    @property
    def n(self) -> int:
        return self.num_clusters * self.devices_per_cluster

    @property
    def tiers(self) -> Tuple[int, ...]:
        """Resolved branching factors root→leaf: ``hierarchy`` when set,
        else the two-tier ``(num_clusters, devices_per_cluster)``."""
        return tuple(self.hierarchy) or (self.num_clusters,
                                         self.devices_per_cluster)

    @property
    def depth(self) -> int:
        """Number of hierarchy tiers (2 for the paper's device→edge)."""
        return len(self.tiers)

    def round_program(self, *, privatize: bool = False,
                      compress: bool = False):
        """Compile this config's τ/q/π knobs into the canonical
        :class:`repro_torch.core.program.RoundProgram` — the declarative round
        schedule every engine lowers (see ``core/program.py``)."""
        from repro_torch.core.program import canonical_program
        return canonical_program(self, privatize=privatize,
                                 compress=compress)

    def validate(self) -> None:
        assert self.algorithm in (
            "ce_fedavg", "fedavg", "hier_favg", "local_edge", "dec_local_sgd")
        assert self.tau >= 1 and self.q >= 1 and self.pi >= 1
        assert self.num_clusters >= 1 and self.devices_per_cluster >= 1
        from repro_torch.core.topology import TOPOLOGIES  # single source of truth
        assert self.topology in TOPOLOGIES, \
            f"unknown topology {self.topology!r}"
        assert self.gossip_impl in self.GOSSIP_IMPLS, \
            f"unknown gossip_impl {self.gossip_impl!r}"
        if self.topology == "torus":
            side = int(round(self.num_clusters ** 0.5))
            assert side * side == self.num_clusters, \
                "torus backhaul needs a square number of clusters"
        if self.topology == "erdos_renyi":
            assert 0.0 < self.er_prob <= 1.0, \
                f"er_prob must be in (0, 1], got {self.er_prob}"
        if self.hierarchy:
            tiers = tuple(self.hierarchy)
            assert len(tiers) >= 2, \
                f"hierarchy needs >= 2 tiers, got {tiers}"
            assert all(t >= 1 for t in tiers), \
                f"hierarchy branching factors must be >= 1: {tiers}"
            prod = 1
            for t in tiers[:-1]:
                prod *= t
            assert prod == self.num_clusters, \
                f"prod(hierarchy[:-1])={prod} != num_clusters=" \
                f"{self.num_clusters}"
            assert tiers[-1] == self.devices_per_cluster, \
                f"hierarchy[-1]={tiers[-1]} != devices_per_cluster=" \
                f"{self.devices_per_cluster}"
            if len(tiers) > 2:
                assert self.algorithm == "ce_fedavg", \
                    "depth>2 hierarchies exist for ce_fedavg only " \
                    f"(got {self.algorithm!r})"
        if self.gossip_impl in ("sparse", "ringweight"):
            # the sparse backends lower the inter-cluster operator with
            # collectives; that path exists for the gossip algorithms only
            assert self.algorithm in ("ce_fedavg", "dec_local_sgd"), \
                f"{self.gossip_impl!r} backend requires a gossip algorithm" \
                f" (ce_fedavg/dec_local_sgd), not {self.algorithm!r}"


# ---------------------------------------------------------------------------
# Wall-clock scenarios (heterogeneity / sampling / mobility)
# ---------------------------------------------------------------------------

SPEED_DISTS = ("homogeneous", "uniform", "lognormal", "bimodal")


@dataclass(frozen=True)
class FaultConfig:
    """Edge/backhaul fault injection knobs.

    Realized per round by ``core.scenario.FaultModel`` with draws keyed
    by ``(seed, round, stream, entity)`` — the fault trace at round t is
    a pure function of (config, t), so a killed-and-resumed run replays
    the identical faults it would have seen uninterrupted.

    Three fault classes, mirroring what a mobile-edge deployment
    actually loses:

    - **Edge-server outages**: each round, each cluster independently
      starts an outage window with prob ``outage_prob``; the window
      lasts 1..``outage_len`` rounds (keyed draw at window start). A
      dark cluster trains nothing and its rows/columns are gated out of
      every mixing operator (identity rows, deficit folded onto the
      diagonal — see ``gossip.fault_gate``).
    - **Backhaul link loss**: each inter-edge backhaul link
      independently drops for the round with prob ``link_drop_prob``;
      the round's gossip runs on the surviving (possibly partitioned)
      graph, re-weighted per connected component.
    - **Straggler timeouts**: a participating device whose local-steps
      compute exceeds ``timeout_factor`` x the cohort-median compute is
      aborted and retried with an exponentially backed-off budget
      (``retry_backoff``); after ``max_retries`` failed retries it is
      dropped from the round's cohort. The aborted-attempt ladder is
      priced in ``EventClock`` (see ``clock.fault_compute_penalty``).
    """
    outage_prob: float = 0.0    # per-cluster per-round window-start prob
    outage_len: int = 1         # max outage window length (rounds)
    link_drop_prob: float = 0.0  # per-backhaul-link per-round drop prob
    timeout_factor: float = 0.0  # x median compute; 0 disables timeouts
    max_retries: int = 2        # retry attempts before dropping a device
    retry_backoff: float = 1.5  # budget multiplier per retry attempt
    seed: int = 0               # fault stream seed (independent of scenario)

    def validate(self) -> None:
        assert 0.0 <= self.outage_prob < 1.0
        assert self.outage_len >= 1
        assert 0.0 <= self.link_drop_prob < 1.0
        assert self.timeout_factor >= 0.0
        assert self.max_retries >= 0
        assert self.retry_backoff >= 1.0

    @property
    def trivial(self) -> bool:
        """True iff no fault can ever fire (the parity regime: a
        fault-gated run must match the ungated run bitwise)."""
        return (self.outage_prob == 0.0 and self.link_drop_prob == 0.0
                and self.timeout_factor == 0.0)


@dataclass(frozen=True)
class PopulationConfig:
    """Virtual-client population: per-cluster member-count
    *distributions* replace enumerated devices, so a cluster can claim
    10^4 members without 10^4 resident bank rows.

    Realized once (keyed by the scenario seed) by
    ``core.scenario.PopulationEngine``: each cluster draws its member
    count from ``size_dist`` around ``clients_per_cluster``, client ids
    are the implicit contiguous ranges under the cluster-size prefix
    sums, and every per-round draw (cohort sampling, visit mobility,
    per-client speeds) is keyed by ``SeedSequence`` — never stateful —
    so a resumed run replays the identical population trace. Client
    state lives in the streaming ``core.clientstore.ClientStore``:
    only each round's cohort is resident, cold rows are stored under
    ``codec``, and each cohort client trains on data shard
    ``client_id % n`` of the enumerated per-device data."""
    clients_per_cluster: int = 1000  # mean cluster size
    size_dist: str = "fixed"         # fixed | uniform | lognormal
    size_spread: float = 0.0         # uniform half-width / lognormal sigma
    cohort_per_cluster: int = 4      # sampled members per cluster per round
    codec: str = "f32"               # cold-row codec (compress.COLD_CODECS)

    SIZE_DISTS = ("fixed", "uniform", "lognormal")

    def validate(self) -> None:
        assert self.clients_per_cluster >= 1
        assert self.size_dist in self.SIZE_DISTS, \
            f"unknown size_dist {self.size_dist!r}"
        assert self.size_spread >= 0.0
        if self.size_dist == "uniform":
            assert self.size_spread < 1.0, \
                "uniform size spread must leave clusters nonempty"
        assert self.cohort_per_cluster >= 1
        from repro_torch.core.compress import COLD_CODECS
        assert self.codec in COLD_CODECS, \
            f"unknown cold-row codec {self.codec!r}"


@dataclass(frozen=True)
class ScenarioConfig:
    """A wall-clock scenario: who trains each round, how fast, and where.

    Consumed by ``core.scenario.ScenarioEngine`` which re-draws the
    participation mask and (under mobility) the cluster assignment B_t
    between global rounds, and by ``core.clock.EventClock`` which charges
    each round the slowest *participating* device's compute plus the
    algorithm's communication terms (eq. 8 with the max_k rule).

    With ``population`` set, the scenario describes a *virtual*
    population instead of the enumerated devices:
    ``core.scenario.PopulationEngine`` draws each round's cohort from
    the per-cluster size distributions and ``FLSimulator`` runs the
    streamed client-store engine (O(cohort) resident memory).
    """
    name: str = "homogeneous"
    # -- device-speed heterogeneity (multipliers on hw.device_flops) --------
    speed_dist: str = "homogeneous"  # one of SPEED_DISTS
    speed_spread: float = 0.0        # uniform: half-width; lognormal: sigma
    slow_fraction: float = 0.25      # bimodal: fraction of slow devices
    slow_factor: float = 0.1         # bimodal: slow devices' relative speed
    # -- per-round client sampling ------------------------------------------
    sample_fraction: float = 1.0     # fraction of devices training per round
    dropout_prob: float = 0.0        # straggler dropout among the sampled
    # -- mobility ------------------------------------------------------------
    move_prob: float = 0.0           # per-device per-round re-association prob
    seed: int = 0
    # -- fault injection (None = fault-free) ---------------------------------
    faults: "FaultConfig | None" = None
    # -- virtual population (None = enumerated devices) ----------------------
    population: "PopulationConfig | None" = None

    def validate(self) -> None:
        assert self.speed_dist in SPEED_DISTS, \
            f"unknown speed_dist {self.speed_dist!r}"
        assert self.speed_spread >= 0.0
        if self.speed_dist == "uniform":
            assert self.speed_spread < 1.0, "uniform spread must leave c>0"
        assert 0.0 <= self.slow_fraction <= 1.0
        assert 0.0 < self.slow_factor <= 1.0
        assert 0.0 < self.sample_fraction <= 1.0
        assert 0.0 <= self.dropout_prob < 1.0
        assert 0.0 <= self.move_prob <= 1.0
        if self.faults is not None:
            self.faults.validate()
        if self.population is not None:
            self.population.validate()
            assert self.faults is None or self.faults.trivial, \
                "fault injection is not supported with a virtual " \
                "population (FaultModel realizes per enumerated device)"

    @property
    def trivial(self) -> bool:
        """True iff the scenario cannot change the training trajectory
        (full participation, no mobility) — the parity regime in which the
        masked schedule must reduce to the static operators."""
        return (self.sample_fraction >= 1.0 and self.dropout_prob == 0.0
                and self.move_prob == 0.0
                and (self.faults is None or self.faults.trivial)
                and self.population is None)


# ---------------------------------------------------------------------------
# Mesh / distribution
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axes: Tuple[str, ...] = ("data", "model")
    multi_pod: bool = False

    @property
    def num_devices(self) -> int:
        out = 1
        for s in self.shape:
            out *= s
        return out


# ---------------------------------------------------------------------------
# Train / serve shapes (the four assigned input shapes)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


INPUT_SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


@dataclass(frozen=True)
class TrainConfig:
    optimizer: str = "sgd"        # sgd | adamw
    learning_rate: float = 0.05
    momentum: float = 0.9
    weight_decay: float = 0.0
    lr_schedule: str = "constant"  # constant | cosine | warmup_cosine
    warmup_steps: int = 0
    total_steps: int = 1000
    batch_size: int = 50          # per-device local batch (paper: 50)
    seed: int = 0
    remat: bool = False           # activation checkpointing for the block
    # the reference's switch to route attention/ssd through its Pallas
    # kernels, which it never reads; the port always runs its kernels on
    # the card and its plain versions on the CPU
    use_pallas: bool = False


@dataclass(frozen=True)
class ExperimentConfig:
    model: ModelConfig
    fl: FLConfig = field(default_factory=FLConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    train: TrainConfig = field(default_factory=TrainConfig)

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)
