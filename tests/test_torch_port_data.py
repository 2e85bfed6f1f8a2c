"""PyTorch port: the samplers and loaders (horovod_tpu_torch/data/) against
the JAX package's data/ on the same inputs.

* ``DistributedSampler`` index streams and lengths for several
  ``(n, rank, size, seed, epoch, shuffle, drop_last)``;
* ``ElasticSampler``: the streams, the remaining indices after
  ``record_batch``, a resize (``load_state_dict`` / ``reset`` with
  another world size), ``cursor`` and ``state_dict``;
* ``shard_batch_indices`` and its refusal;
* ``AsyncDataLoader`` yields the batches in order (queue on and off),
  ``seek`` fast-forwards the next iteration only, a producer's exception
  reaches the consumer, ``close`` mid-iteration does not hang.
"""

import itertools

import pytest

from horovod_tpu.data import loader as jloader
from horovod_tpu.data import sampler as jsampler
from horovod_tpu_torch.data import loader as tloader
from horovod_tpu_torch.data import sampler as tsampler

SAMPLER_CASES = [
    (10, 0, 1, 0, 0, True, False), (10, 1, 3, 5, 2, True, False),
    (17, 2, 4, 1, 0, False, False), (17, 3, 4, 9, 1, True, True),
    (64, 5, 8, 42, 3, True, False), (7, 6, 8, 0, 0, True, False),
]


@pytest.mark.parametrize("n,rank,size,seed,epoch,shuffle,drop_last",
                         SAMPLER_CASES)
def test_distributed_sampler_matches_reference(n, rank, size, seed, epoch,
                                               shuffle, drop_last):
    def run(mod):
        s = mod.DistributedSampler(n, shuffle=shuffle, seed=seed, rank=rank,
                                   size=size, drop_last=drop_last)
        s.set_epoch(epoch)
        return list(s), len(s)

    assert run(tsampler) == run(jsampler)


@pytest.mark.parametrize("n,rank,size,seed,epoch,shuffle,drop_last",
                         SAMPLER_CASES)
def test_elastic_sampler_matches_reference(n, rank, size, seed, epoch,
                                           shuffle, drop_last):
    def run(mod):
        s = mod.ElasticSampler(n, shuffle=shuffle, seed=seed, rank=rank,
                               size=size)
        s.set_epoch(epoch)
        out = [list(s), len(s), s.state_dict()]
        s.record_batch(0, 2)
        s.record_batch(1, 1)
        out += [s.cursor(), s.state_dict()]
        state = s.state_dict()
        # A resize: the same progress re-split over another world.
        new_size = max(1, size // 2) if size > 1 else 3
        r = mod.ElasticSampler(n, shuffle=shuffle, seed=seed,
                               rank=min(rank, new_size - 1), size=new_size)
        r.load_state_dict(state)
        out += [list(r), len(r), r.remaining_indices, r.total_size]
        r.load_state_dict({"epoch": epoch, "processed_num": 0})  # pre-cursor
        out += [r.cursor(), list(r)]
        return out

    assert run(tsampler) == run(jsampler)


@pytest.mark.parametrize("batch,rank,size", [(8, 0, 1), (8, 3, 4),
                                             (12, 1, 3), (10, 0, 4)])
def test_shard_batch_indices_matches_reference(batch, rank, size):
    def run(mod):
        try:
            return mod.shard_batch_indices(batch, rank, size)
        except ValueError as e:
            return str(e)

    assert run(tsampler) == run(jsampler)


@pytest.mark.parametrize("queue_size", [0, 1, 4])
def test_async_loader_yields_batches_in_order(queue_size):
    batches = [[i, i * i] for i in range(25)]

    def run(mod):
        ld = mod.AsyncDataLoader(batches, async_loader_queue_size=queue_size)
        first = list(ld)
        ld.seek({"epoch": 0, "batch_idx": 7})
        sought = list(ld)
        again = list(ld)           # the seek applies once
        ld.seek((1, 30))
        past_end = list(ld)
        ld.close()
        return first, sought, again, past_end, len(ld)

    got = run(tloader)
    assert got == run(jloader)
    assert got[0] == batches and got[1] == batches[7:] and got[3] == []


def test_producer_exception_reaches_the_consumer():
    class Boom(Exception):
        pass

    class Failing(tloader.AsyncDataLoaderMixin, tloader.BaseDataLoader):
        def __len__(self):
            return 3

        def _iterate(self):
            yield 1
            raise Boom("upstream")

    ld = Failing(async_loader_queue_size=2)
    it = iter(ld)
    assert next(it) == 1
    with pytest.raises(Boom):
        next(it)
    ld.close()


def test_close_mid_iteration_does_not_hang():
    ld = tloader.AsyncDataLoader(range(10_000), async_loader_queue_size=2,
                                 close_timeout_s=5.0)
    assert list(itertools.islice(iter(ld), 3)) == [0, 1, 2]
    ld.close()
    assert ld._thread is None


def test_seek_rejects_a_negative_cursor():
    with pytest.raises(ValueError):
        tloader.AsyncDataLoader([1]).seek(-1)
