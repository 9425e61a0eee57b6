"""Chronology-respecting scheduling of the match stream onto the device.

Ratings are a temporal recurrence: the posterior of a match is the prior
of each player's next match. This package turns the time-ordered stream
into conflict-free supersteps (no shared player within a step, each
player's matches in order across steps) and rates them chunk by chunk.
"""

from analyzer_tpu_torch.sched.superstep import (
    MatchStream,
    PackedSchedule,
    WindowedSchedule,
    assign_batches,
    assign_supersteps,
    choose_batch_size,
    choose_batch_size_streamed,
    pack_schedule,
)
from analyzer_tpu_torch.sched.feed import DeviceFeed, FeedStageError, Prefetcher
from analyzer_tpu_torch.sched.residency import (
    FuseSpec,
    ResidencyPlan,
    check_plan,
    plan_windows,
    rate_window_checked,
    resolve_fuse,
)
from analyzer_tpu_torch.sched.runner import HistoryOutputs, rate_history, rate_stream
from analyzer_tpu_torch.sched.tier import TierManager

__all__ = [
    "DeviceFeed",
    "FeedStageError",
    "FuseSpec",
    "HistoryOutputs",
    "MatchStream",
    "PackedSchedule",
    "Prefetcher",
    "ResidencyPlan",
    "TierManager",
    "WindowedSchedule",
    "assign_batches",
    "assign_supersteps",
    "check_plan",
    "choose_batch_size",
    "choose_batch_size_streamed",
    "pack_schedule",
    "plan_windows",
    "rate_history",
    "rate_stream",
    "rate_window_checked",
    "resolve_fuse",
]
