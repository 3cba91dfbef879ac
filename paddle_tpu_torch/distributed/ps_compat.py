# Copy of paddle_tpu/distributed/ps_compat.py, code unchanged (only
# comments and docstrings differ); tests/test_torch_kv_pager_copy.py
# compares the two as token streams.
"""Parameter-server era input surface, host only (numpy and the
stdlib): ``EntryAttr`` / ``ProbabilityEntry`` / ``CountFilterEntry``,
the MultiSlot data generators and the datasets that parse their
protocol ("<n> v1 .. vn" per slot, one sample per line) into padded
[batch, max_len] numpy arrays per slot, which
``static.Executor.train_from_dataset`` feeds one batch a run.

ref: python/paddle/distributed/entry_attr.py,
distributed/fleet/data_generator/data_generator.py,
distributed/fleet/dataset/dataset.py."""
from __future__ import annotations

import os
import sys

import numpy as np


# ---------------------------------------------------------------- entries
class EntryAttr:
    """Sparse-row admission config for sparse_embedding (ref
    entry_attr.py:20).  With no parameter server the table is dense, so
    entries are carried as declarative metadata (accessible to tooling
    via _to_attr) rather than PS-server filters."""

    def __init__(self):
        self._name = None

    def _to_attr(self):
        raise NotImplementedError("EntryAttr is base class")


class ProbabilityEntry(EntryAttr):
    """Admit new sparse features with the given probability (ref :59)."""

    def __init__(self, probability):
        super().__init__()
        if not isinstance(probability, float):
            raise ValueError("probability must be a float in (0,1)")
        if probability <= 0 or probability >= 1:
            raise ValueError("probability must be a float in (0,1)")
        self._name = "probability_entry"
        self._probability = probability

    def _to_attr(self):
        return ":".join([self._name, str(self._probability)])


class CountFilterEntry(EntryAttr):
    """Admit a sparse feature after `count_filter` occurrences (ref :100)."""

    def __init__(self, count_filter):
        super().__init__()
        if not isinstance(count_filter, int):
            raise ValueError(
                "count_filter must be a valid integer greater than 0")
        if count_filter < 0:
            raise ValueError(
                "count_filter must be a valid integer greater or equal "
                "than 0")
        self._name = "count_filter_entry"
        self._count_filter = count_filter

    def _to_attr(self):
        return ":".join([self._name, str(self._count_filter)])


# ---------------------------------------------------------- data generator
class DataGenerator:
    """User subclasses override ``generate_sample(line)`` (returning a
    generator of [(slot, [feasign, ...]), ...]) and optionally
    ``generate_batch`` (ref data_generator.py:21).  run_from_stdin
    reproduces the reference's trainer-pipe protocol byte for byte."""

    def __init__(self):
        self._proto_info = None
        self.batch_size_ = 32

    def set_batch(self, batch_size):
        self.batch_size_ = batch_size

    def generate_sample(self, line):
        raise NotImplementedError(
            "generate_sample() must be overridden: return a generator "
            "yielding [(slot_name, [feasign, ...]), ...] per sample")

    def generate_batch(self, samples):
        def local_iter():
            for s in samples:
                yield s
        return local_iter

    def _gen_str(self, line):
        raise NotImplementedError(
            "use MultiSlotDataGenerator or MultiSlotStringDataGenerator")

    def _run_samples(self, sample_iters):
        """Shared buffering core: accumulate parsed samples to batch_size_,
        flush each full batch (and the trailing partial one) through
        generate_batch -> _gen_str -> stdout."""
        batch_samples = []

        def _flush():
            batch_iter = self.generate_batch(batch_samples)
            for sample in batch_iter():
                sys.stdout.write(self._gen_str(sample))

        for line_iter in sample_iters:
            for user_parsed_line in line_iter():
                if user_parsed_line is None:
                    continue
                batch_samples.append(user_parsed_line)
                if len(batch_samples) == self.batch_size_:
                    _flush()
                    batch_samples = []
        if batch_samples:
            _flush()

    def run_from_stdin(self):
        """stdin lines -> protocol lines on stdout (the pipe_command
        contract)."""
        self._run_samples(self.generate_sample(line) for line in sys.stdin)

    def run_from_memory(self):
        """Debug path: generate without input lines, write to stdout."""
        self._run_samples([self.generate_sample(None)])


class MultiSlotStringDataGenerator(DataGenerator):
    """Slots carry pre-stringified feasigns (ref :239): output
    ``<n> s1 .. sn`` per slot."""

    def _gen_str(self, line):
        if isinstance(line, zip):
            line = list(line)
        if not isinstance(line, (list, tuple)):
            raise ValueError(
                "the output of process() must be in list or tuple type, "
                "e.g. [('words', ['1926', '08', '17']), ('label', ['1'])]")
        out = []
        for _name, elements in line:
            out.append(str(len(elements)))
            out.extend(str(e) for e in elements)
        return " ".join(out) + "\n"


class MultiSlotDataGenerator(DataGenerator):
    """Slots carry int/float feasigns with a consistency-checked proto
    (ref :283): first sample fixes the field set and int/float kinds."""

    def _gen_str(self, line):
        if isinstance(line, zip):
            line = list(line)
        if not isinstance(line, (list, tuple)):
            raise ValueError(
                "the output of process() must be in list or tuple type, "
                "e.g. [('words', [1926, 8, 17]), ('label', [1])]")
        if self._proto_info is None:
            self._proto_info = []
            first = True
        else:
            first = False
            if len(line) != len(self._proto_info):
                raise ValueError("the complete field set of two given "
                                 "line are inconsistent.")
        out = []
        for index, (name, elements) in enumerate(line):
            if not isinstance(name, str):
                raise ValueError(f"name {type(name)} must be in str type")
            if not isinstance(elements, list):
                raise ValueError(
                    f"elements {type(elements)} must be in list type")
            if not elements:
                raise ValueError(
                    "the elements of each field can not be empty, you "
                    "need padding it in process().")
            if first:
                self._proto_info.append((name, "uint64"))
            elif name != self._proto_info[index][0]:
                raise ValueError(
                    "the field name of two given line are not match: "
                    f"require<{self._proto_info[index][0]}>, get<{name}>.")
            out.append(str(len(elements)))
            for elem in elements:
                if isinstance(elem, float):
                    self._proto_info[index] = (name, "float")
                elif not isinstance(elem, (int, np.integer)):
                    raise ValueError(
                        f"the type of element {type(elem)} must be in "
                        "int or float")
                out.append(str(elem))
        return " ".join(out) + "\n"


# ----------------------------------------------------------------- dataset
def _parse_multislot_line(line, n_slots):
    """One protocol line -> list of per-slot numpy value lists."""
    toks = line.split()
    slots, i = [], 0
    for _ in range(n_slots):
        if i >= len(toks):
            raise ValueError(f"truncated MultiSlot line: {line!r}")
        n = int(toks[i])
        vals = toks[i + 1:i + 1 + n]
        if len(vals) != n:
            raise ValueError(f"truncated MultiSlot line: {line!r}")
        slots.append(vals)
        i += 1 + n
    if i != len(toks):
        raise ValueError(
            f"MultiSlot line has {len(toks) - i} trailing token(s) beyond "
            f"the {n_slots} declared slots — slot count mismatch between "
            f"the data and dataset.init(use_var=...): {line!r}")
    return slots


class DatasetBase:
    """Common init/config of the reference's dataset family (ref
    dataset.py:38): slot vars, batch size, file list.  ``pipe_command``
    is honored by piping each file through it exactly like the trainer
    does (a DataGenerator script works unchanged); leave it empty to
    read files already in protocol format."""

    def __init__(self):
        self._batch_size = 1
        self._thread_num = 1
        self._use_vars = []
        self._pipe_command = ""
        self._input_type = 0
        self._filelist = []
        self._pad_lens = {}    # slot idx -> stable padded length

    def init(self, batch_size=1, thread_num=1, use_var=None,
             pipe_command="", input_type=0, fs_name="", fs_ugi="",
             download_cmd="cat", **kwargs):
        self._batch_size = int(batch_size)
        self._thread_num = max(int(thread_num), 1)
        self._use_vars = list(use_var or [])
        self._pipe_command = pipe_command
        self._input_type = input_type
        return self

    # individual setters (the pre-2.0 spelling scripts use)
    def set_batch_size(self, batch_size):
        self._batch_size = int(batch_size)

    def set_thread(self, thread_num):
        self._thread_num = max(int(thread_num), 1)

    def set_use_var(self, var_list):
        self._use_vars = list(var_list)

    def set_pipe_command(self, pipe_command):
        self._pipe_command = pipe_command

    def set_filelist(self, filelist):
        self._filelist = list(filelist)

    def get_filelist(self):
        return list(self._filelist)

    # -- parsing ----------------------------------------------------------
    def _slot_dtypes(self):
        out = []
        for v in self._use_vars:
            d = np.dtype(getattr(v.value, "dtype", np.float32))
            out.append(np.int64 if d.kind in "iu" else np.float32)
        return out

    def _read_protocol_lines(self, path):
        if self._pipe_command:
            import subprocess
            with open(path, "rb") as f:
                proc = subprocess.run(
                    self._pipe_command, shell=True, stdin=f,
                    stdout=subprocess.PIPE, check=True)
            text = proc.stdout.decode()
        else:
            with open(path, "r", encoding="utf-8") as f:
                text = f.read()
        return [ln for ln in text.splitlines() if ln.strip()]

    def _samples_from_files(self):
        n_slots = len(self._use_vars)
        if n_slots == 0:
            raise ValueError("dataset.init(use_var=...) must name the "
                             "slot variables before reading data")
        samples = []
        for path in self._filelist:
            for ln in self._read_protocol_lines(path):
                samples.append(_parse_multislot_line(ln, n_slots))
        return samples

    # ---- PS-era knobs (ref dataset.py): accepted for API shape; the
    # port has no distributed instance-id plumbing to configure
    def preprocess_instance(self):
        pass

    def postprocess_instance(self):
        pass

    def set_parse_ins_id(self, parse_ins_id):
        pass

    def set_parse_content(self, parse_content):
        pass

    def _init_distributed_settings(self, **kwargs):
        pass

    def update_settings(self, **kwargs):
        for k, v in kwargs.items():
            setattr(self, "_" + k, v)

    def set_queue_num(self, queue_num):
        self._queue_num = queue_num

    def set_fleet_send_batch_size(self, n=1024):
        pass

    def set_fleet_send_sleep_seconds(self, n=0):
        pass

    def set_merge_by_lineid(self, merge_size=2):
        pass

    def slots_shuffle(self, slots):
        pass

    def _slot_pad_len(self, si, batch_max):
        """Stable per-slot padded length.  Padding each batch to ITS max
        would hand the Executor a different feed shape per batch — one
        prepared replay each.  Lengths grow monotonically and round up
        to powers of two, so ragged data converges to a handful of
        shapes (InMemoryDataset pins the exact dataset max at load)."""
        cur = self._pad_lens.get(si, 0)
        if batch_max <= cur:
            return cur
        t = 1
        while t < batch_max:
            t *= 2
        self._pad_lens[si] = max(t, cur)
        return self._pad_lens[si]

    def _batches(self, samples):
        """Pad each slot to a stable length -> {name: [B, L] array}
        (the fixed-shape analogue of the reference's LoD batches)."""
        dtypes = self._slot_dtypes()
        names = [getattr(v, "name", f"slot_{i}")
                 for i, v in enumerate(self._use_vars)]
        bs = self._batch_size
        for start in range(0, len(samples), bs):
            chunk = samples[start:start + bs]
            if not chunk:
                continue
            feed = {}
            for si, (name, dt) in enumerate(zip(names, dtypes)):
                rows = [np.asarray(s[si], dt) for s in chunk]
                L = self._slot_pad_len(si, max(r.shape[0] for r in rows))
                arr = np.zeros((len(rows), L), dt)
                for ri, r in enumerate(rows):
                    arr[ri, :r.shape[0]] = r
                feed[name] = arr
            yield feed


class QueueDataset(DatasetBase):
    """Streaming dataset (ref dataset.py:1086): batches parse lazily per
    epoch, nothing is cached."""

    def iter_batches(self):
        n_slots = len(self._use_vars)
        if n_slots == 0:
            raise ValueError("dataset.init(use_var=...) must name the "
                             "slot variables before reading data")
        buf = []
        for path in self._filelist:
            for ln in self._read_protocol_lines(path):
                buf.append(_parse_multislot_line(ln, n_slots))
                if len(buf) >= self._batch_size:
                    yield from self._batches(buf[:self._batch_size])
                    buf = buf[self._batch_size:]
        if buf:
            yield from self._batches(buf)


class InMemoryDataset(DatasetBase):
    """Load-then-shuffle dataset (ref dataset.py:253)."""

    def __init__(self):
        super().__init__()
        self._memory = []
        self._seed = None

    def load_into_memory(self):
        self._memory = self._samples_from_files()
        # the whole dataset is in hand: pin each slot's padded length to
        # the exact dataset-wide max so every batch shares ONE feed shape
        for si in range(len(self._use_vars)):
            if self._memory:
                self._pad_lens[si] = max(
                    len(np.asarray(s[si]).reshape(-1))
                    for s in self._memory)

    def preload_into_memory(self, thread_num=None):
        self.load_into_memory()

    def wait_preload_done(self):
        pass

    def set_shuffle_by_uid(self, enable):
        pass

    def local_shuffle(self):
        rng = np.random.RandomState(self._seed)
        rng.shuffle(self._memory)

    def global_shuffle(self, fleet=None, thread_num=12):
        # single-controller: global == local
        self.local_shuffle()

    def get_memory_data_size(self, fleet=None):
        return len(self._memory)

    def get_shuffle_data_size(self, fleet=None):
        return len(self._memory)

    def release_memory(self):
        self._memory = []

    def slots_shuffle(self, slots):
        pass

    def iter_batches(self):
        if not self._memory:
            raise RuntimeError(
                "call load_into_memory() before iterating an "
                "InMemoryDataset")
        yield from self._batches(self._memory)
