"""The naive oracle of tests/test_naive_oracle.py against the port's BigMAT
(usher_tpu_torch.core.bigmat, CPU tensors).

`naive_score` is built from the semantic definition of the reference scorer
(full root-path states per node, the own-branch rule per position, plain
counting), with none of the engines' difference arrays or aggregates.  The
same seeds, MAT shapes and samples as the JAX package's test go through
the port's interval engine (X8, `score_batch_T`), its host mirror
(`place_one_host`) and its device-reduced placement (X5, `place_arrays`),
the engine behind usher-sampled --bigmat.  Tolerance: none.
"""

import numpy as np
import pytest

from usher_tpu_torch.core.bigmat import BigMAT

from test_naive_oracle import NIBBLES, encode, naive_score, random_sample


@pytest.fixture(autouse=True)
def _cpu(monkeypatch):
    monkeypatch.setenv("USHER_TPU_PLATFORM", "cpu")


def random_consistent_big(rng, N, P, n_mut=2):
    """test_naive_oracle.random_consistent_big (the same draws from `rng`)
    with the port's BigMAT on CPU tensors."""
    ref = NIBBLES[rng.integers(0, 4, size=P)]
    parent = np.zeros(N, dtype=np.int32)
    parent[1:] = (rng.random(N - 1) * np.arange(1, N)).astype(np.int32)
    state = np.tile(ref, (N, 1))
    cols, pars, muts, ptr = [], [], [], [0]
    for i in range(N):
        if i:
            state[i] = state[parent[i]]
            for c in sorted(rng.choice(P, size=n_mut,
                                       replace=False).tolist()):
                pv = int(state[i, c])
                alts = [int(x) for x in NIBBLES if int(x) != pv]
                mv = alts[int(rng.integers(3))]
                state[i, c] = mv
                cols.append(c)
                pars.append(pv)
                muts.append(mv)
        ptr.append(len(cols))
    big = BigMAT(parent, np.array(ptr, np.int64),
                 np.array(cols, np.int32), np.array(pars, np.uint8),
                 np.array(muts, np.uint8),
                 np.arange(P, dtype=np.int64), ref, device="cpu")
    return big, state


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4, 5, 6, 7])
def test_interval_engine_vs_naive(seed):
    rng = np.random.default_rng(seed)
    big, state = random_consistent_big(rng, N=120, P=40)
    for _ in range(6):
        sample = random_sample(rng, big.P, big.ref)
        pos, gval, kmiss = encode(big, sample)
        sT, ncT, nnm = big.score_batch_T(pos, gval, kmiss)
        oracle = naive_score(big, state, sample)
        for n, (score, nc, _hu, _valid) in enumerate(oracle):
            assert sT[n, 0] == score, (seed, n)
            assert ncT[n, 0] == nc, (seed, n)
        best, slot, num_best, hu = big.place_one_host(pos, gval, kmiss)
        vscores = [s for (s, _n, _h, v) in oracle if v]
        assert best == min(vscores)
        assert num_best == sum(1 for (s, _n, _h, v) in oracle
                               if v and s == best)
        bs, bslot, bnb, bhu = big.place_arrays(pos, gval, kmiss)
        assert (int(bs[0]), int(bslot[0]), int(bnb[0]), bool(bhu[0])) \
            == (best, slot, num_best, hu)
        ties = [n for n, (s, _n2, _h, v) in enumerate(oracle)
                if v and s == best]
        lmax = max(int(big.num_leaves[n]) for n in ties)
        ties = [n for n in ties if int(big.num_leaves[n]) == lmax]
        want = max(ties, key=lambda n: int(big.bfs_rank[n]))
        assert slot == want
        assert hu == oracle[want][2]
