"""Host work plans of the split tensor-core walks over a token block's page
worklist (rows 1 and 3: the ragged GQA and the ragged MLA kernels), at a
capacity fixed per token bucket.

A plan is made on the host, once a unified step, from the host copy of
``page_count`` that ``pack_page_meta`` returns (so no device value is read
back).  It cuts each token block's worklist ``[0, page_count[t])`` into
work items of about equal length; a block with one item is written by that
item, the items of a split block write float32 partials that a combine
merges in entry order.

The kernels take the plan as one int32 buffer of int4 rows in device
memory:

  row 0                 live items, live combines, live partials, 0
  rows 1 .. 1 + I       the items: (token block, first entry, end entry,
                        partial slot or -1)
  rows 1 + I .. + C     the combines: (token block, first slot, slots, 0)

where I and C are the buffer's capacities (``WorkCaps``).  The grid is the
capacity; a CTA past the live count (read on the device) exits at once, so
one launch, and one CUDA graph, serves every window of a bucket.  The
partials scratch is laid out at the capacity as well.

The capacity is a bound, not a guess.  With ``target`` the items a plan
aims at and ``L >= total / target`` the planned length, a block of ``c``
entries gets ``n = round(c / L)`` items (clipped to ``[1, c // min_len]``
and ``max_per_block``).  A split block (n >= 2) has ``c >= 1.5 L`` and
``n <= c / L + 1/2``; so ``s``, the split blocks, are at most ``2 target /
3``, the partials at most ``total / L + s / 2 <= 4 target / 3`` and the
items at most ``num_tb - s + partials <= num_tb + target``, whatever the
page counts of the bucket's ``num_tb`` blocks (``Planner.caps``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dynamo_tpu_torch.ops.kernels.common import ceil_div

MAX_GRID_ITEMS = 65535  # items a launch may have (a grid extent)


@dataclass(frozen=True)
class WorkCaps:
    """Rows a plan buffer holds (items, combines) and the partial slots its
    scratch holds."""
    items: int
    combines: int
    partials: int

    @property
    def rows(self) -> int:
        """int4 rows of the plan buffer: the header, items, combines."""
        return 1 + self.items + self.combines


@dataclass
class DeviceWork:
    """A plan as the kernels read it: ``buffer`` (int32 [caps.rows, 4] on
    the device, laid out as above) for ``num_tb`` token blocks, and the
    float32 partials ``scratch`` at ``caps.partials`` slots (None: the
    wrapper allocates it a call)."""
    num_tb: int
    caps: WorkCaps
    buffer: torch.Tensor
    scratch: torch.Tensor | None = None


class WorkPlan:
    """One step's work items and combines (numpy int32 [n, 4] each).

    ``items``: (token block, first entry, end entry, partial slot or -1),
    in any order (the planner lists the longest first, the order the grid
    starts them).  A token block's items tile its worklist ``[0,
    page_count[t])``; a block with one item has slot -1 (the walk writes
    its output), a block with several gives each a partial slot, numbered
    in entry order across the blocks in block order.  ``combines``: (token
    block, first slot, slots, 0) for every block with several items; the
    combine merges those slots in order.

    The constructor refuses, by name, items that do not cover every
    block's ``[0, page_count)`` exactly once, or whose slots do not follow
    that numbering."""

    NAME = "work plan"
    MAX_PER_BLOCK = 64  # items a token block may have (the combine's list)

    def __init__(self, items, page_count):
        items = np.asarray(items, np.int32).reshape(-1, 4)
        counts = np.asarray(page_count, np.int64).reshape(-1)
        if len(items) > MAX_GRID_ITEMS:
            raise ValueError(f"{self.NAME}: {len(items)} items exceed the grid's "
                             f"{MAX_GRID_ITEMS}")
        ordered = items[np.lexsort((items[:, 1], items[:, 0]))]
        split = self._check_items(ordered, counts)
        first = np.r_[True, ordered[1:, 0] != ordered[:-1, 0]] & split
        n_of = np.bincount(ordered[:, 0], minlength=counts.size)
        combines = np.stack([ordered[first, 0], ordered[first, 3], n_of[ordered[first, 0]],
                             np.zeros(int(first.sum()), np.int64)], 1)
        self.items = items
        self.combines = combines.astype(np.int32).reshape(-1, 4)
        self.n_partials = int(split.sum())
        self.num_tb = int(counts.size)
        self._device: dict[torch.device, DeviceWork] = {}

    @property
    def caps(self) -> WorkCaps:
        """The tightest capacity that holds this plan."""
        return WorkCaps(len(self.items), len(self.combines), self.n_partials)

    def fits(self, caps: WorkCaps) -> bool:
        c = self.caps
        return c.items <= caps.items and c.combines <= caps.combines and c.partials <= caps.partials

    def pack(self, caps: WorkCaps | None = None) -> np.ndarray:
        """The plan buffer (int32 [caps.rows, 4]) at ``caps`` (default: the
        tightest), dead rows zero.  Refuses a plan that does not fit."""
        caps = caps or self.caps
        if not self.fits(caps):
            raise ValueError(f"{self.NAME}: {self.caps} does not fit the capacity {caps}")
        out = np.zeros((caps.rows, 4), np.int32)
        out[0, :3] = (len(self.items), len(self.combines), self.n_partials)
        out[1: 1 + len(self.items)] = self.items
        out[1 + caps.items: 1 + caps.items + len(self.combines)] = self.combines
        return out

    def device_work(self, device: torch.device) -> DeviceWork:
        """The plan buffer at the tightest capacity on ``device``, copied
        once a plan (every layer of the step reads the same copy), from
        pinned memory: a pageable copy would wait for the stream, so for a
        window still in flight."""
        if device not in self._device:
            buf = torch.from_numpy(self.pack())
            if device.type == "cuda":
                buf = buf.pin_memory()
            self._device[device] = DeviceWork(
                self.num_tb, self.caps, buf.to(device, non_blocking=True))
        return self._device[device]

    @classmethod
    def _check_items(cls, items: np.ndarray, counts: np.ndarray) -> np.ndarray:
        """Refuse ``items`` (sorted by block, then first entry) that do not
        tile every block's ``[0, page_count)`` exactly once, or whose slots
        are not the numbering above; return which items are partials."""
        name = cls.NAME
        block, first, end, slot = (items[:, i].astype(np.int64) for i in range(4))
        num_tb = counts.size
        if block.size == 0:
            if num_tb:
                raise ValueError(f"{name}: token block 0 has no item")
            return np.zeros(0, bool)
        if ((block < 0) | (block >= num_tb)).any():
            raise ValueError(f"{name}: a token block outside [0, {num_tb})")
        n_of = np.bincount(block, minlength=num_tb)
        if (n_of == 0).any():
            raise ValueError(f"{name}: token block {int(np.argmin(n_of))} has no item")
        if n_of.max(initial=0) > cls.MAX_PER_BLOCK:
            raise ValueError(f"{name}: a token block has {n_of.max()} items, "
                             f"more than {cls.MAX_PER_BLOCK}")
        starts = np.r_[True, block[1:] != block[:-1]]
        lasts = np.r_[block[1:] != block[:-1], True]
        prev_end = np.r_[0, end[:-1]]
        tiles = (np.where(starts, first == 0, first == prev_end)
                 & np.where(lasts, end == counts[block], True)
                 & ((end > first) | ((end == first) & (counts[block] == 0))))
        if not tiles.all():
            bad = int(block[np.argmin(tiles)])
            raise ValueError(f"{name}: the items of token block {bad} do not "
                             f"cover its entries [0, {int(counts[bad])}) exactly once")
        split = n_of[block] > 1
        if not (slot == np.where(split, np.cumsum(split) - 1, -1)).all():
            raise ValueError(f"{name}: partial slots must number the items of "
                             "split token blocks in order, and be -1 elsewhere")
        return split


def launch_args(plan: WorkPlan | DeviceWork, device: torch.device, slot_rows: int,
                width: int, name: str) -> tuple:
    """A plan's arguments to a split walk's C entry: (plan buffer, partial
    acc, partial m and l: pointers or None; the capacities of items,
    combines and partials), and the scratch tensor, which the caller holds
    until it launched.  A host plan goes to the card at its tightest
    capacity; the partials (``slot_rows`` rows of ``width`` accumulators,
    then m and l, a slot) are the DeviceWork's scratch, else allocated for
    the call."""
    dw = plan if isinstance(plan, DeviceWork) else plan.device_work(device)
    if (dw.buffer.dtype != torch.int32 or dw.buffer.device != device
            or not dw.buffer.is_contiguous() or dw.buffer.shape != (dw.caps.rows, 4)):
        raise ValueError(f"{name}: the plan buffer must be a contiguous int32 "
                         f"[{dw.caps.rows}, 4] tensor on {device}")
    caps = (dw.caps.items, dw.caps.combines, dw.caps.partials)
    if not dw.caps.partials:
        return (dw.buffer.data_ptr(), None, None, caps), None
    n_rows = dw.caps.partials * slot_rows
    scratch = dw.scratch
    if scratch is None:
        scratch = torch.empty(n_rows * (width + 2), dtype=torch.float32, device=device)
    elif (scratch.dtype != torch.float32 or scratch.device != device
          or scratch.numel() < n_rows * (width + 2)):
        raise ValueError(f"{name}: scratch of {scratch.numel()} {scratch.dtype} on "
                         f"{scratch.device}, the capacity needs {n_rows * (width + 2)} "
                         f"float32 on {device}")
    acc = scratch.data_ptr()
    return (dw.buffer.data_ptr(), acc, acc + n_rows * width * 4, caps), scratch


@dataclass(frozen=True)
class Planner:
    """A walk's planner for one geometry: its aims (``target`` items a
    step, items of at least ``min_len`` entries but a block's only one),
    the plan class (its name and items a block), and the floats one
    partial slot takes in the scratch (0: not known here)."""
    plan_cls: type
    target: int
    min_len: int
    partial_floats: int = 0

    def plan(self, page_count) -> WorkPlan:
        """Items about ``length = max(min_len, ceil(total / target))``
        long: each block of ``c`` entries is cut into ``round(c / length)``
        items of equal length (within one), at least one, at most ``c //
        min_len`` and the plan class's items a block, so no item is longer
        than 1.5 ``length`` unless its block is capped.  Listed longest
        first (a stable sort: ties keep block order)."""
        counts = np.asarray(page_count, np.int64).reshape(-1)
        num_tb = counts.size
        length = max(self.min_len, ceil_div(int(counts.sum()), self.target))
        n = np.clip(np.minimum((2 * counts + length) // (2 * length), counts // self.min_len),
                    1, self.plan_cls.MAX_PER_BLOCK)
        block = np.repeat(np.arange(num_tb), n)
        k = np.arange(block.size) - np.repeat(np.cumsum(n) - n, n)
        c, nb = counts[block], n[block]
        first, end = k * c // nb, (k + 1) * c // nb
        split = nb > 1
        slot = np.where(split, np.cumsum(split) - 1, -1)
        items = np.stack([block, first, end, slot], 1)
        items = items[np.argsort(first - end, kind="stable")]
        return self.plan_cls(items, counts)

    def caps(self, num_tb: int) -> WorkCaps:
        """The capacity every plan of ``num_tb`` token blocks fits (the
        bound in the module's docstring, and the items a block cap)."""
        t, most = self.target, self.plan_cls.MAX_PER_BLOCK
        items = min(num_tb + t, num_tb * most)
        if items > MAX_GRID_ITEMS:
            raise ValueError(f"{self.plan_cls.NAME}: {items} items for {num_tb} token "
                             f"blocks exceed the grid's {MAX_GRID_ITEMS}")
        return WorkCaps(items, min(2 * t // 3, num_tb), min(4 * t // 3, num_tb * most))

    def scratch_floats(self, caps: WorkCaps) -> int:
        return caps.partials * self.partial_floats
