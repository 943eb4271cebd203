"""The yardstick on the CPU: the traffic generator, the bytes of a kernel
launch, the FLOP count of a batch, the comparison that decides
``correct`` and the reduction of a profiler trace."""

import json
import os

import pytest
import torch

from benchmark import run
from benchmark.reference import steps as ref_steps
from benchmark.yardstick import compare, flops, roofline, trace, traffic


def test_epoch_orders_are_permutations_drawn_from_the_seed():
    big = 2 ** 31 + 11
    a = traffic.epoch_order(big, 3, 17)
    assert a == traffic.epoch_order(big, 3, 17)
    assert sorted(a) == list(range(17))
    assert a != traffic.epoch_order(big, 4, 17)
    assert a != traffic.epoch_order(big + 1, 3, 17)
    assert traffic.noise_seed(big) == traffic.noise_seed(big)
    assert traffic.noise_seed(big) != traffic.noise_seed(big + 1)


def test_batches_of_a_traffic():
    tr = run.load_json(run.HERE, 'traffic', 'hopv-epochs.json')
    assert traffic.n_batches(350, 20) == 17        # the short last one out
    assert traffic.n_batches(360, 20) == 18
    assert len(traffic.rows(tr, run.ROOT)) >= 17 * 20
    assert isinstance(tr['scan_chunk'], int) and tr['scan_chunk'] >= 1
    assert isinstance(tr['warmup_epochs'], int) and tr['warmup_epochs'] >= 1


def test_bytes_of_launches():
    h = torch.zeros(10, 4)
    graph = torch.tensor([[1, 2], [2, 0], [0, 0]], dtype=torch.int32)
    # distinct rows 0, 1, 2 and three output rows of 4 floats, the table
    assert roofline.nei_sum_bytes(h, graph) == 4 * (3 + 3) * 4 + 4 * 6
    # distinct rows 3, six gathered rows
    assert roofline.gather_rows_bytes(h, graph) == 4 * (3 + 6) * 4 + 4 * 6
    t_idx = torch.tensor([[0, 0], [1, 2], [3, 0]], dtype=torch.int32)
    t_mask = torch.tensor([[0, 0], [1, 1], [1, 0]], dtype=torch.float32)
    # real entries read rows 1 // 2, 2 // 2, 3 // 2: two distinct
    assert roofline.transpose_sum_bytes(h, t_idx, t_mask, 2) == \
        4 * (2 + 3) * 4 + 8 * 6


def test_bound_takes_the_faster_peak():
    hbm = roofline.PEAKS['hbm_bytes_per_s']
    n = 2 ** 20 + 1                        # class 2**20 + 2**16
    c = roofline.size_class(n)
    assert c == 2 ** 20 + 2 ** 16 and roofline.size_class(c) == c
    assert roofline.bound_s(n, {}) == (n / hbm, 'hbm')
    assert roofline.bound_s(n, {c: 2 * hbm}) == (n / (2 * hbm), 'l2_copy')
    assert roofline.bound_s(n, {c: hbm / 2}) == (n / hbm, 'hbm')


@pytest.fixture(scope='module')
def motif():
    cfg = run.load_json(run.HERE, 'configs', 'ggpm-motif-prop.json')
    model, vocab = ref_steps.load_model(cfg, run.ROOT)
    rows = ref_steps.read_rows(os.path.join(run.ROOT, 'data/hopv15.csv'),
                               vocab)
    return cfg, model, vocab, rows


def test_flops_of_a_batch_are_its_own(motif):
    cfg, model, vocab, rows = motif
    batch = ref_steps.batch_rows(rows, cfg['batch_size'], 0)
    a = flops.step_flops(model, vocab, cfg, batch)
    assert a == flops.step_flops(model, vocab, cfg, batch) > 0
    other = ref_steps.batch_rows(rows, cfg['batch_size'], 1)
    assert flops.step_flops(model, vocab, cfg, other) != a


@pytest.mark.parametrize('config', ['ggpm-motif-prop', 'ggpm-hier-prop'])
def test_flops_count_the_backward_each_product_needs(config):
    from torch.utils.flop_counter import FlopCounterMode
    cfg = run.load_json(run.HERE, 'configs', config + '.json')
    model, vocab = ref_steps.load_model(cfg, run.ROOT)
    rows = ref_steps.read_rows(os.path.join(run.ROOT, 'data/hopv15.csv'),
                               vocab)[:4]
    counted = flops.step_flops(model, vocab, cfg, rows)
    batch = ref_steps.device_batch(rows, vocab, 'cpu', pad=False)
    with FlopCounterMode(display=False) as exact:
        total, _ = model(batch, cfg['beta'])
        torch.autograd.grad(total, list(model.parameters()),
                            allow_unused=True)
    # a product whose output reaches no loss has no backward
    assert exact.get_total_flops() <= counted <= \
        1.01 * exact.get_total_flops()


def _leaves(scale=1.0):
    g = torch.Generator().manual_seed(0)
    return {f'l{i}': scale * torch.randn(5 + i, generator=g)
            for i in range(5)}


def test_numbers_of_identical_runs_are_zero():
    rec = {'losses': [3.0, 2.5, 2.0], 'grad1': _leaves(), 'delta': _leaves()}
    assert compare.training_numbers(rec, rec) == {
        'loss1_gap': 0.0, 'grad_gap': 0.0, 'update_median_gap': 0.0}


def test_a_state_left_unchanged_reads_one():
    ref = {'losses': [3.0, 2.5, 2.0], 'grad1': _leaves(), 'delta': _leaves()}
    zero = {k: torch.zeros_like(v) for k, v in ref['delta'].items()}
    num = compare.training_numbers(dict(ref, grad1=zero, delta=zero), ref)
    assert num['grad_gap'] == pytest.approx(1.0)
    assert num['update_median_gap'] == pytest.approx(1.0)


def test_leaves_the_reference_does_not_move_are_left_out():
    ref = {'losses': [1.0], 'grad1': _leaves(), 'delta': _leaves()}
    ref['grad1']['bias'] = torch.full((3,), 1e-12)
    ref['delta']['bias'] = torch.full((3,), 1e-3)
    prog = {k: dict(v) if isinstance(v, dict) else v for k, v in ref.items()}
    prog['delta']['bias'] = -5 * ref['delta']['bias']      # rounding's walk
    assert compare.training_numbers(prog, ref)['update_median_gap'] == 0.0
    assert compare.details(prog, ref)['left_out'] == ['bias']


def test_later_numbers_take_the_worst_step_and_leaf():
    rec = {'loss': 2.0, 'grad': _leaves(), 'delta': _leaves()}
    bad = dict(rec, delta=dict(rec['delta'], l0=2 * rec['delta']['l0']))
    num = compare.later_numbers([rec, bad], [rec, rec])
    assert num['later_loss_gap'] == 0.0 and num['later_grad_gap'] == 0.0
    assert num['later_update_gap'] == pytest.approx(1.0)
    empty = compare.later_numbers([], [])
    assert not any(c['ok'] for c in compare.judge(empty, dict.fromkeys(
        empty, 1.0)))


def test_judge_fails_nan_and_what_passes_a_limit():
    out = compare.judge({'a': float('nan'), 'b': 2e-6, 'c': 1.0},
                        {'a': 1.0, 'b': 1e-5, 'c': 0.5})
    assert [c['ok'] for c in out] == [False, True, False]


class _Event:
    def __init__(self, name, start, dur, cuda):
        from torch.autograd import DeviceType
        self._n, self._s, self._d = name, start, dur
        self._t = DeviceType.CUDA if cuda else DeviceType.CPU

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._t

    def is_user_annotation(self):
        return False


class _Prof:
    def __init__(self, events):
        results = type('R', (), {'events': lambda _: events})()
        self.profiler = type('P', (), {'kineto_results': results})()


def test_trace_reduction():
    host = [(100, 500, 'train_step'), (550, 700, 'device_batch')]
    ev = [_Event('void gather_wide<4>(...)', 20, 30, True),
          _Event('transpose_sum_kernel<1>', 40, 60, True),
          _Event('sgemm', 300, 100, True),
          _Event('fill', 450, 70, True),
          _Event('aten::mm', 450, 70, False),       # a host record
          _Event('sgemm', 800, 300, True)]          # runs past the window
    red = trace.reduce(_Prof(ev), (0, 1000), host)
    assert red['window_s'] == pytest.approx(1e-6)
    assert red['busy_s'] == pytest.approx((80 + 100 + 70 + 200) * 1e-9)
    assert red['outside_s'] == pytest.approx(100e-9)
    assert dict(red['idle_gaps']) == pytest.approx(
        {'train_step': 250e-9, 'device_batch': 280e-9, trace.OUTSIDE: 20e-9})
    assert red['kernels'] == {
        'gather_rows': {'records': 1, 'seconds': pytest.approx(30e-9)},
        'transpose_sum': {'records': 1, 'seconds': pytest.approx(60e-9)}}
    assert red['top_ops'][0] == ['sgemm', pytest.approx(300e-9)]


def test_metric_readers_leave_out_what_they_cannot_read():
    for m in run.load_json(run.ROOT, 'BENCHMARK.json')['per_layer']:
        assert run.reader(m['name'])({}) is None, m['name']
    rec = json.loads(json.dumps({
        'trace': {'busy_s': 0.5, 'window_s': 2.0,
                  'kernels': {'nei_sum': {'records': 9, 'seconds': 9e-6}}},
        'trace_steps': 10, 'bound_s': {'nei_sum': 5e-6},
        'launches_counted': {'nei_sum': 10},
        'launches_ran': {'nei_sum': 10}}))
    assert run.reader('device_idle_share')(rec) == pytest.approx(75.0)
    assert run.reader('device_busy_ms_per_step')(rec) == pytest.approx(50.0)
    # ten launches of 1 µs each bound at 0.5 µs
    assert run.reader('port_kernels_roofline')(rec) == pytest.approx(50.0)
    # 6.7e9 FLOPs in 0.5 s of busy device: 13.4 TFLOP/s of 67
    rec['flops_per_epoch'] = 6.7e9
    assert run.reader('step_mfu')(rec) == pytest.approx(20.0 * 1e-3)
