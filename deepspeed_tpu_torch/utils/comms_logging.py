"""Per-op communication counts, bytes and latency: the port's own copy of
``deepspeed_tpu/utils/comms_logging.py`` (``CommsLogger``, the algorithmic
and bus bandwidth of ``calc_bw_log``, ``convert_size``).

Bandwidth follows the standard collective-cost model: for an all-reduce
over n ranks the bus carries 2·(n-1)/n · size, for an all-gather or a
reduce-scatter (n-1)/n · n · size. ``totals()`` gives each op's count and
bytes summed over message sizes, what a step's accounting reads.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List

from .logging import log_dist


def get_caller_func(frame_depth: int = 3) -> str:
    import sys

    return sys._getframe(frame_depth).f_code.co_name


def convert_size(size_bytes: float) -> str:
    if size_bytes == 0:
        return "0B"
    size_name = ("B", "KB", "MB", "GB", "TB", "PB")
    i = int(math.floor(math.log(size_bytes, 1024)))
    p = math.pow(1024, i)
    s = round(size_bytes / p, 2)
    return f"{s} {size_name[i]}"


def calc_bw_log(comm_op: str, size: int, duration: float, n: int) -> tuple:
    """(algbw, busbw) in Gbps. ``n`` = ranks participating."""
    duration = max(duration, 1e-9)
    if comm_op in ("all_to_all_single", "all_to_all"):
        tput = size / duration
        busbw = (size / duration) * ((n - 1) / n) if n > 1 else size / duration
    elif comm_op in ("all_gather", "all_gather_into_tensor", "reduce_scatter",
                     "reduce_scatter_tensor", "all_gather_object"):
        size *= n
        tput = size / duration
        busbw = (size / duration) * ((n - 1) / n) if n > 1 else size / duration
    elif comm_op in ("all_reduce", "inference_all_reduce"):
        tput = size * 2 / duration
        busbw = (size / duration) * (2 * (n - 1) / n) if n > 1 else size / duration
    else:  # send/recv/broadcast/reduce/barrier
        tput = size / duration
        busbw = tput
    # bytes/sec → Gbps
    return tput * 8 / 1e9, busbw * 8 / 1e9


class CommsLogger:
    def __init__(self, enabled: bool = False, prof_all: bool = True, prof_ops=None,
                 verbose: bool = False, debug: bool = False):
        self.enabled = enabled
        self.prof_all = prof_all
        self.prof_ops = prof_ops or []
        self.verbose = verbose
        self.debug = debug
        self.comms_dict: Dict[str, Dict[int, List]] = defaultdict(dict)

    def configure(self, comms_config) -> None:
        """Read a ``comms_logger`` config block (``enabled``, ``verbose``,
        ``debug``, ``prof_ops``, ``prof_all``)."""
        self.enabled = comms_config.enabled
        if self.enabled:
            self.verbose = comms_config.verbose
            self.debug = comms_config.debug
            self.prof_ops = list(comms_config.prof_ops)
            self.prof_all = comms_config.prof_all

    def start_profiling_comms(self):
        self.enabled = True

    def stop_profiling_comms(self):
        self.enabled = False

    def reset(self) -> None:
        self.comms_dict = defaultdict(dict)

    def append(self, raw_name: str, record_name: str, latency: float, msg_size: int,
               n_ranks: int) -> None:
        algbw, busbw = calc_bw_log(raw_name, msg_size, latency, n_ranks)
        if record_name in self.comms_dict:
            if msg_size in self.comms_dict[record_name]:
                self.comms_dict[record_name][msg_size][0] += 1
                self.comms_dict[record_name][msg_size][1].append(latency)
                self.comms_dict[record_name][msg_size][2].append(algbw)
                self.comms_dict[record_name][msg_size][3].append(busbw)
            else:
                self.comms_dict[record_name][msg_size] = [1, [latency], [algbw], [busbw]]
        else:
            self.comms_dict[record_name][msg_size] = [1, [latency], [algbw], [busbw]]
        if self.verbose:
            log_dist(
                f"comm op: {record_name} | time (ms): {latency * 1e3:.2f} | "
                f"msg size: {convert_size(msg_size)} | algbw (Gbps): {algbw:.2f} | "
                f"busbw (Gbps): {busbw:.2f}", [0])

    def totals(self) -> Dict[str, Dict[str, float]]:
        """``{record name: {"count", "bytes", "latency_s"}}`` summed over
        message sizes."""
        out = {}
        for name, entries in self.comms_dict.items():
            out[name] = {
                "count": sum(v[0] for v in entries.values()),
                "bytes": sum(size * v[0] for size, v in entries.items()),
                "latency_s": sum(sum(v[1]) for v in entries.values())}
        return out

    def log_all(self, print_log: bool = True, show_straggler: bool = False):
        from copy import deepcopy

        lines = [f"{'Comm. Op': <20}{'Message Size': <20}{'Count': <20}"
                 f"{'Total Latency(ms)': <20}{'Avg Latency(ms)': <20}"
                 f"{'tput_avg (Gbps)': <20}{'busbw_avg (Gbps)': <20}"]
        out = deepcopy(self.comms_dict)
        for record_name, entries in out.items():
            lines.append(record_name)
            for msg_size, vals in sorted(entries.items()):
                count, latencies, algbws, busbws = vals
                total_lat = sum(latencies)
                avg_lat = total_lat / count
                avg_algbw = sum(algbws) / count
                avg_busbw = sum(busbws) / count
                lines.append(
                    f"{' ': <20}{convert_size(msg_size): <20}{count: <20}"
                    f"{total_lat * 1e3: <20.2f}{avg_lat * 1e3: <20.2f}"
                    f"{avg_algbw: <20.2f}{avg_busbw: <20.2f}")
        summary = "\n".join(lines)
        if print_log:
            log_dist("\n" + summary, [0])
        return out
