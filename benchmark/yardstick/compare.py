"""The comparison that decides ``correct`` for a training cell.

The program's first steps, taken by the same call the window drives, are
held to the reference's steps on the same rows from the same checkpoint
and noise by three numbers:

* ``loss1_gap``: of the first step's loss, ``|program − reference| /
  |reference|`` (both start from the checkpoint);
* ``grad_gap``: of the first step's gradient as the optimizer got it
  (clipped), the worst leaf's ``|‖g_p‖ − ‖g_r‖| / max(‖g_r‖, median
  leaf ‖g_r‖)``;
* ``update_median_gap``: of the parameters' change over the steps, the
  median leaf's ``|‖Δ_p‖ − ‖Δ_r‖| / max(‖Δ_r‖, median leaf ‖Δ_r‖)``,
  over the leaves whose first reference gradient is at least ``MOVED`` of
  the median leaf's: a leaf whose gradient is nought but for rounding (a
  bias under a softmax) moves under Adam by its rounding alone, on either
  side.

A gap of norms, not the norm of a difference: Adam moves every entry by
about the learning rate whatever the size of its gradient, so entries
whose gradient is rounding noise flip sign between two sound runs and
leave the norm as it is.  A state left unchanged reads 1 in ``grad_gap``
(Adam's first moment stays nought) and 0.7 to 1 in ``update_median_gap``
(a leaf whose change is under the median's reads its share of it).  The
later steps' losses and the worst leaf's change carry those flips (a flipped
entry of ``matchNN.bias`` moves every assembly score): they swing from
seed to seed, and are reported (``details``) but not compared.

The steps after the first that replay a captured graph, or run eagerly
through another call, are held by three more numbers, each the worst
over the checked later steps (``later_numbers``), where the reference
takes the step from the program's own state before it (its parameters
and Adam's moments; ``reference.steps.follow``), so that no flip of an
earlier step carries into them:

* ``later_loss_gap``: the step's loss, as ``loss1_gap``;
* ``later_grad_gap``: the step's clipped gradient, the program's worked
  out from its first moments before and after the step (``(mu_k − b1 ·
  mu_{k−1}) / (1 − b1)``), as ``grad_gap``;
* ``later_update_gap``: the step's change of the parameters against
  Adam's move from the program's state with the program's gradient, the
  worst leaf's gap of norms (the update stage alone: the gradient is
  ``later_grad_gap``'s).
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import torch

MOVED = 1e-3


def _median(values) -> float:
    v = sorted(values)
    return v[len(v) // 2] if len(v) % 2 else 0.5 * (v[len(v) // 2 - 1] +
                                                     v[len(v) // 2])


def _norms(leaves: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double()))
            for k, v in leaves.items()}


def leaf_gaps(program: Mapping[str, torch.Tensor],
              reference: Mapping[str, torch.Tensor],
              keep=None) -> Dict[str, float]:
    """Each leaf's gap of norms (above), over the leaves in ``keep`` (all
    where None)."""
    if set(program) != set(reference):
        raise ValueError(f'leaves differ: {sorted(set(program) ^ set(reference))}')
    pn, rn = _norms(program), _norms(reference)
    names = [k for k in rn if keep is None or k in keep]
    floor = _median([rn[k] for k in names])
    return {k: abs(pn[k] - rn[k]) / max(rn[k], floor, 1e-30) for k in names}


def _moved(reference: Dict) -> set:
    gn = _norms(reference['grad1'])
    floor = _median(gn.values())
    return {k for k, v in gn.items() if v >= MOVED * floor}


def details(program: Dict, reference: Dict) -> Dict:
    """Beside the numbers: each step's loss gap, the leaf that reads worst
    in the gradient and in the change, the worst leaf's change gap, and
    the leaves left out of the change."""
    grad = leaf_gaps(program['grad1'], reference['grad1'])
    upd = leaf_gaps(program['delta'], reference['delta'], _moved(reference))
    return {'loss_gaps': [abs(a - b) / abs(b) for a, b in
                          zip(program['losses'], reference['losses'])],
            'losses': [program['losses'], reference['losses']],
            'grad_worst': max(grad, key=grad.get),
            'update_worst': max(upd, key=upd.get),
            'update_worst_gap': max(upd.values()),
            'left_out': sorted(set(reference['delta']) - _moved(reference))}


def training_numbers(program: Dict, reference: Dict) -> Dict[str, float]:
    """``loss1_gap``, ``grad_gap`` and ``update_median_gap`` of two
    records, each with ``losses`` (a float a step), ``grad1`` (leaf -> the
    first step's clipped gradient) and ``delta`` (leaf -> the parameters'
    change over the steps)."""
    lp, lr = program['losses'], reference['losses']
    if len(lp) != len(lr):
        raise ValueError(f'{len(lp)} program steps against {len(lr)}')
    grad = leaf_gaps(program['grad1'], reference['grad1'])
    upd = leaf_gaps(program['delta'], reference['delta'], _moved(reference))
    return {'loss1_gap': abs(lp[0] - lr[0]) / abs(lr[0]),
            'grad_gap': max(grad.values()),
            'update_median_gap': _median(upd.values())}


def _worst(gaps: Mapping[str, float]):
    k = max(gaps, key=gaps.get)
    return k, gaps[k]


def later_numbers(program: Sequence[Dict], reference: Sequence[Dict]
                  ) -> Dict[str, float]:
    """``later_loss_gap``, ``later_grad_gap`` and ``later_update_gap``
    (above) of the checked later steps: a record a step on each side, each
    with ``loss``, ``grad`` and ``delta`` (leaf -> tensor); NaN, which
    fails every limit, where no step was checked."""
    if len(program) != len(reference):
        raise ValueError(f'{len(program)} program steps against '
                         f'{len(reference)}')
    if not program:
        return dict.fromkeys(('later_loss_gap', 'later_grad_gap',
                              'later_update_gap'), float('nan'))
    return {'later_loss_gap': max(abs(p['loss'] - r['loss']) / abs(r['loss'])
                                  for p, r in zip(program, reference)),
            'later_grad_gap': max(max(leaf_gaps(p['grad'], r['grad']).values())
                                  for p, r in zip(program, reference)),
            'later_update_gap': max(max(leaf_gaps(p['delta'],
                                                  r['delta']).values())
                                    for p, r in zip(program, reference))}


def later_details(program: Sequence[Dict], reference: Sequence[Dict]
                  ) -> list:
    """Each checked later step's gaps and the leaves that read worst."""
    out = []
    for p, r in zip(program, reference):
        g = _worst(leaf_gaps(p['grad'], r['grad']))
        u = _worst(leaf_gaps(p['delta'], r['delta']))
        out.append({'step': p.get('step'), 'kind': p.get('kind'),
                    'loss_gap': abs(p['loss'] - r['loss']) / abs(r['loss']),
                    'grad_worst': list(g), 'update_worst': list(u)})
    return out


def judge(numbers: Dict[str, float], limits: Dict[str, float]
          ) -> Sequence[Dict]:
    """Each number beside its limit, and whether it is within."""
    return [{'name': k, 'value': numbers[k], 'limit': limits[k],
             'ok': bool(numbers[k] <= limits[k])} for k in limits]
