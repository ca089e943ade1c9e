"""Master JSON config: the port's ``deepspeed_tpu/runtime/config.py``.

The whole DeepSpeed JSON surface parses, as in the JAX package, and the
central batch invariant ``train_batch_size = micro_batch_per_gpu ×
gradient_accumulation_steps × dp_world_size`` is enforced. The training
slice runs batch reconciliation, ``bf16``/``fp16`` (loss-scale keys),
``gradient_clipping``, ``optimizer``, ``scheduler``,
``zero_optimization.stage`` with its ``offload_optimizer`` and
``offload_param`` blocks (cpu and nvme), ``aio``, ``steps_per_print``,
``seed`` and ``prescale_gradients``/``gradient_predivide_factor``.
:meth:`DeepSpeedConfig.not_ported` names every key that is set to
something other than off for a feature this port does not have yet;
the engine raises ``NotImplementedError`` for them.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Union

import torch

from ..utils.logging import logger
from .config_utils import (DeepSpeedConfigModel,
                           dict_raise_error_on_duplicate_keys)
from .zero.config import DeepSpeedZeroConfig

_field = dataclasses.field


def _block(cls):
    return _field(default_factory=cls)


@dataclasses.dataclass
class FP16Config(DeepSpeedConfigModel):
    enabled: bool = False
    auto_cast: bool = False
    loss_scale: float = 0.0  # 0 = dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    min_loss_scale: float = 1.0
    fp16_master_weights_and_grads: bool = False


@dataclasses.dataclass
class BF16Config(DeepSpeedConfigModel):
    enabled: bool = False
    bf16_master_weights: bool = True


@dataclasses.dataclass
class OptimizerConfig(DeepSpeedConfigModel):
    type: str = "Adam"
    params: Dict[str, Any] = _field(default_factory=dict)
    legacy_fusion: bool = False


@dataclasses.dataclass
class SchedulerConfig(DeepSpeedConfigModel):
    type: Optional[str] = None
    params: Dict[str, Any] = _field(default_factory=dict)


@dataclasses.dataclass
class ActivationCheckpointingConfig(DeepSpeedConfigModel):
    partition_activations: bool = False
    contiguous_memory_optimization: bool = False
    cpu_checkpointing: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False


@dataclasses.dataclass
class MonitorBackendConfig(DeepSpeedConfigModel):
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedJobName"


@dataclasses.dataclass
class WandbConfig(DeepSpeedConfigModel):
    enabled: bool = False
    group: Optional[str] = None
    team: Optional[str] = None
    project: str = "deepspeed"


@dataclasses.dataclass
class MonitorConfig(DeepSpeedConfigModel):
    tensorboard: MonitorBackendConfig = _block(MonitorBackendConfig)
    wandb: WandbConfig = _block(WandbConfig)
    csv_monitor: MonitorBackendConfig = _block(MonitorBackendConfig)
    jsonl: MonitorBackendConfig = _block(MonitorBackendConfig)

    @property
    def enabled(self) -> bool:
        return (self.tensorboard.enabled or self.wandb.enabled
                or self.csv_monitor.enabled or self.jsonl.enabled)


@dataclasses.dataclass
class CommsLoggerConfig(DeepSpeedConfigModel):
    enabled: bool = False
    verbose: bool = False
    prof_all: bool = True
    debug: bool = False
    prof_ops: List[str] = _field(default_factory=list)


@dataclasses.dataclass
class FlopsProfilerConfig(DeepSpeedConfigModel):
    enabled: bool = False
    recompute_fwd_factor: float = 0.0
    profile_step: int = 1
    module_depth: int = -1
    top_modules: int = 1
    detailed: bool = True
    output_file: Optional[str] = None


@dataclasses.dataclass
class PipelineConfig(DeepSpeedConfigModel):
    stages: Union[int, str] = "auto"
    partition: str = "best"
    seed_layers: bool = False
    activation_checkpoint_interval: int = 0
    pipe_partitioned: bool = True
    grad_partitioned: bool = True
    schedule: str = "1f1b"


@dataclasses.dataclass
class AutotuningBlock(DeepSpeedConfigModel):
    enabled: bool = False
    metric: str = "throughput"
    metric_path: Optional[str] = None
    start_profile_step: int = 3
    end_profile_step: int = 5
    model_info: Dict[str, Any] = _field(default_factory=dict)


@dataclasses.dataclass
class HybridEngineConfig(DeepSpeedConfigModel):
    enabled: bool = False
    max_out_tokens: int = 512
    inference_tp_size: int = 1
    release_inference_cache: bool = False
    pin_parameters: bool = True
    tp_gather_partition_size: int = 8
    lora_scaling: float = 1.0


@dataclasses.dataclass
class MeshDims(DeepSpeedConfigModel):
    """Degrees of parallelism (the JAX package's ``"mesh"`` extension)."""

    data: int = -1  # -1 = fill remaining devices
    model: int = 1
    pipe: int = 1
    expert: int = 1
    seq: int = 1


@dataclasses.dataclass
class NebulaConfig(DeepSpeedConfigModel):
    enabled: bool = False
    persistent_storage_path: Optional[str] = None
    persistent_time_interval: int = 100
    num_of_version_in_retention: int = 2
    enable_nebula_load: bool = True


@dataclasses.dataclass
class CheckpointConfig(DeepSpeedConfigModel):
    tag_validation: str = "Warn"
    load_universal: bool = False
    use_node_local_storage: bool = False
    parallel_write: Dict[str, Any] = _field(default_factory=dict)


@dataclasses.dataclass
class DataTypesConfig(DeepSpeedConfigModel):
    grad_accum_dtype: Optional[str] = None


@dataclasses.dataclass
class AioConfig(DeepSpeedConfigModel):
    block_size: int = 1048576
    queue_depth: int = 8
    thread_count: int = 1
    single_submit: bool = False
    overlap_events: bool = True


@dataclasses.dataclass
class CurriculumParams(DeepSpeedConfigModel):
    enabled: bool = False
    curriculum_type: str = "seqlen"
    min_difficulty: int = 8
    max_difficulty: int = 1024
    schedule_type: str = "fixed_linear"
    schedule_config: Dict[str, Any] = _field(default_factory=dict)
    seqlen_key: str = "input_ids"


@dataclasses.dataclass
class EigenvalueConfig(DeepSpeedConfigModel):
    enabled: bool = False
    verbose: bool = False
    max_iter: int = 100
    tol: float = 1e-2
    stability: float = 1e-6
    gas_boundary_resolution: int = 1
    layer_name: str = "bert.encoder.layer"
    layer_num: int = 0


ONEBIT_OPTIMIZERS = ("onebitadam", "onebitlamb", "zerooneadam")


@dataclasses.dataclass
class DeepSpeedConfig(DeepSpeedConfigModel):
    train_batch_size: Optional[int] = None
    train_micro_batch_size_per_gpu: Optional[int] = None
    gradient_accumulation_steps: Optional[int] = None

    steps_per_print: int = 10
    wall_clock_breakdown: bool = False
    memory_breakdown: bool = False
    dump_state: bool = False
    check_rank_consistency: bool = False

    prescale_gradients: bool = False
    gradient_predivide_factor: float = 1.0
    gradient_clipping: float = 0.0
    sparse_gradients: bool = False

    zero_optimization: DeepSpeedZeroConfig = _block(DeepSpeedZeroConfig)
    fp16: FP16Config = _block(FP16Config)
    bf16: BF16Config = _block(BF16Config)
    optimizer: Optional[OptimizerConfig] = None
    scheduler: Optional[SchedulerConfig] = None

    activation_checkpointing: ActivationCheckpointingConfig = _block(
        ActivationCheckpointingConfig)

    tensorboard: Optional[MonitorBackendConfig] = None  # legacy top level
    monitor_config: MonitorConfig = _block(MonitorConfig)
    comms_logger: CommsLoggerConfig = _block(CommsLoggerConfig)
    flops_profiler: FlopsProfilerConfig = _block(FlopsProfilerConfig)
    pipeline: PipelineConfig = _block(PipelineConfig)
    hybrid_engine: HybridEngineConfig = _block(HybridEngineConfig)
    mesh: MeshDims = _block(MeshDims)
    checkpoint: CheckpointConfig = _block(CheckpointConfig)
    nebula: NebulaConfig = _block(NebulaConfig)
    data_types: DataTypesConfig = _block(DataTypesConfig)
    aio: AioConfig = _block(AioConfig)
    curriculum_learning: CurriculumParams = _block(CurriculumParams)
    eigenvalue: EigenvalueConfig = _block(EigenvalueConfig)
    compression_training: Optional[Dict[str, Any]] = None
    autotuning: AutotuningBlock = _block(AutotuningBlock)

    zero_allow_untested_optimizer: bool = False
    zero_force_ds_cpu_optimizer: bool = True
    communication_data_type: Optional[str] = None
    seed: int = 1234
    disable_allgather: bool = False

    @classmethod
    def load(cls, config: Union[str, Dict, "DeepSpeedConfig", None] = None,
             world_size: int = 1, **kwargs) -> "DeepSpeedConfig":
        """Parse a path or dict (or keyword arguments) and reconcile the
        batch sizes for ``world_size`` data-parallel replicas."""
        if isinstance(config, DeepSpeedConfig):
            return config
        if config is None:
            data = dict(kwargs)
        elif isinstance(config, str):
            with open(config, "r") as fh:
                data = json.load(
                    fh, object_pairs_hook=dict_raise_error_on_duplicate_keys)
        elif isinstance(config, dict):
            data = dict(config)
        else:
            raise ValueError(f"Expected a path or dict config, got "
                             f"{type(config)}")
        # legacy top-level monitor keys fold into monitor_config
        monitor = dict(data.get("monitor_config") or {})
        for legacy in ("tensorboard", "wandb", "csv_monitor", "jsonl"):
            if legacy in data and legacy not in monitor:
                monitor[legacy] = data[legacy]
        data["monitor_config"] = monitor
        out = cls.from_dict(data)
        out._do_batch_reconciliation(world_size)
        out._do_sanity_check()
        return out

    def _do_batch_reconciliation(self, world_size: int) -> None:
        """train_batch = micro_batch × gas × dp_world: any two determine the
        third; one alone fills defaults."""
        train = self.train_batch_size
        micro = self.train_micro_batch_size_per_gpu
        gas = self.gradient_accumulation_steps
        if train is not None and micro is not None and gas is not None:
            pass
        elif train is not None and micro is not None:
            gas = train // (micro * world_size)
        elif train is not None and gas is not None:
            micro = train // (gas * world_size)
        elif micro is not None and gas is not None:
            train = micro * gas * world_size
        elif train is not None:
            gas = 1
            micro = train // world_size
        elif micro is not None:
            gas = 1
            train = micro * world_size
        else:
            raise ValueError("Either train_batch_size or "
                             "train_micro_batch_size_per_gpu needs to be "
                             "provided")
        self.train_batch_size = train
        self.train_micro_batch_size_per_gpu = micro
        self.gradient_accumulation_steps = gas
        if train != micro * gas * world_size:
            raise ValueError(
                f"Check batch related parameters. train_batch_size is not "
                f"equal to micro_batch_per_gpu * gradient_acc_step * "
                f"world_size: {train} != {micro} * {gas} * {world_size}")

    def _do_sanity_check(self) -> None:
        if self.fp16.enabled and self.bf16.enabled:
            raise ValueError("fp16 and bf16 modes cannot be enabled "
                             "simultaneously")
        if self.zero_optimization.stage > 0 and not (self.fp16.enabled
                                                     or self.bf16.enabled):
            logger.warning("ZeRO enabled with full fp32 precision")

    def not_ported(self) -> List[str]:
        """Keys set (to anything but off) for features this port does not
        have yet."""
        out = []
        opt = self.optimizer
        if opt is not None and opt.type.lower().replace("_", "") in \
                ONEBIT_OPTIMIZERS:
            out.append(f"optimizer.type={opt.type}")
        if opt is not None and opt.params.get("comm_backend_name") == \
                "compressed":
            out.append("optimizer.params.comm_backend_name")
        if self.pipeline.stages not in ("auto", 1):
            out.append("pipeline.stages")
        for key in ("hybrid_engine", "curriculum_learning", "flops_profiler",
                    "eigenvalue", "nebula", "autotuning"):
            if getattr(self, key).enabled:
                out.append(key)
        if "data_efficiency" in self.extra and \
                (self.extra["data_efficiency"] or {}).get("enabled"):
            out.append("data_efficiency")
        if self.monitor_config.enabled:
            out.append("monitor_config")
        if self.compression_training:
            out.append("compression_training")
        # data and tensor parallelism are ported (the mesh's data and
        # model axes, MiCS)
        for axis in ("pipe", "expert", "seq"):
            if getattr(self.mesh, axis) > 1:
                out.append(f"mesh.{axis}")
        return out

    @property
    def zero_enabled(self) -> bool:
        return self.zero_optimization.stage > 0

    @property
    def precision_dtype(self) -> torch.dtype:
        if self.bf16.enabled:
            return torch.bfloat16
        if self.fp16.enabled:
            return torch.float16
        return torch.float32
