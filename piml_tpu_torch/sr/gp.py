"""Self-contained genetic-programming symbolic regression.

A copy of ``piml_tpu/sr/gp.py`` (numpy; it runs on the host).  The
reference delegates symbolic regression to PySR/Julia (reference:
src/symbolic_regression.py:38-52 — binary ops ``+ *``, unary ``exp cos``,
8 populations x 10 iterations).  That stack needs a Julia runtime and
network installs, which the system does not depend on, so this module
implements the same search natively on numpy:

- expression trees over the reference's operator set (+ * exp cos by
  default; - / sin available),
- island-model evolution (``populations`` independent islands with
  periodic migration, like PySR's populations),
- tournament selection, subtree crossover, point/subtree/constant
  mutation,
- local constant optimization (Nelder-Mead via scipy when present,
  numpy hill-climb otherwise) on the current island champions,
- a complexity-indexed hall of fame (pareto front) and PySR's
  score-based ``best`` selection (loss drop per unit complexity).

Deterministic under ``seed``.  Pure numpy + optional scipy — no Julia,
no network, no torch dependency (SR runs on the host).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

try:  # constant polish; numpy fallback below
    from scipy.optimize import minimize as _scipy_minimize
except Exception:  # pragma: no cover
    _scipy_minimize = None

_BINARY: Dict[str, Callable[[np.ndarray, np.ndarray], np.ndarray]] = {
    "+": np.add,
    "-": np.subtract,
    "*": np.multiply,
    "/": lambda a, b: a / np.where(np.abs(b) < 1e-9, np.sign(b) * 1e-9 + 1e-12, b),
    # protected power: |a|^clip(b) keeps the search space finite (sign of a
    # is droppable for force-magnitude laws, which are nonnegative)
    "pow": lambda a, b: np.power(np.clip(np.abs(a), 1e-9, 1e9),
                                 np.clip(b, -5.0, 5.0)),
}
_UNARY: Dict[str, Callable[[np.ndarray], np.ndarray]] = {
    "exp": lambda a: np.exp(np.clip(a, -60.0, 60.0)),
    "cos": np.cos,
    "sin": np.sin,
    "neg": np.negative,
    "log": lambda a: np.log(np.clip(np.abs(a), 1e-9, None)),
    "sqrt": lambda a: np.sqrt(np.abs(a)),
}


class Node:
    """Expression-tree node: constant, variable, unary or binary op."""

    __slots__ = ("op", "left", "right", "value", "var")

    def __init__(self, op: Optional[str] = None, left: "Node" = None,
                 right: "Node" = None, value: float = None, var: int = None):
        self.op = op
        self.left = left
        self.right = right
        self.value = value
        self.var = var

    # -- structure ----------------------------------------------------------
    def is_leaf(self) -> bool:
        return self.op is None

    def copy(self) -> "Node":
        if self.is_leaf():
            return Node(value=self.value, var=self.var)
        return Node(self.op, self.left.copy(),
                    self.right.copy() if self.right is not None else None)

    def nodes(self) -> List["Node"]:
        out = [self]
        if self.left is not None:
            out += self.left.nodes()
        if self.right is not None:
            out += self.right.nodes()
        return out

    def complexity(self) -> int:
        return len(self.nodes())

    def constants(self) -> List["Node"]:
        return [n for n in self.nodes() if n.is_leaf() and n.var is None]

    # -- evaluation ---------------------------------------------------------
    def __call__(self, X: np.ndarray) -> np.ndarray:
        if self.is_leaf():
            if self.var is not None:
                return X[:, self.var]
            return np.full(X.shape[0], self.value)
        if self.right is None:
            return _UNARY[self.op](self.left(X))
        return _BINARY[self.op](self.left(X), self.right(X))

    def __str__(self) -> str:
        if self.is_leaf():
            return f"x{self.var}" if self.var is not None else f"{self.value:.4g}"
        if self.right is None:
            return f"{self.op}({self.left})"
        return f"({self.left} {self.op} {self.right})"


@dataclass
class Equation:
    """One hall-of-fame entry (mirrors a PySR equations row)."""

    complexity: int
    loss: float
    score: float
    expression: str
    tree: Node = field(repr=False)

    def predict(self, X: np.ndarray) -> np.ndarray:
        return self.tree(np.asarray(X, dtype=np.float64))


class GPSymbolicRegressor:
    """PySR-shaped API: ``fit(X, y)`` -> ``equations_`` pareto table.

    Defaults mirror the reference's pysr() call
    (symbolic_regression.py:38-52): populations=8, niterations=10,
    binary ``+ *``, unary ``exp cos``.
    """

    def __init__(
        self,
        binary_operators: Sequence[str] = ("+", "*"),
        unary_operators: Sequence[str] = ("exp", "cos"),
        populations: int = 8,
        population_size: int = 48,
        niterations: int = 10,
        evolutions_per_iteration: int = 500,
        max_complexity: int = 25,
        parsimony: float = 1e-4,
        tournament: int = 5,
        batch_size: int = 2000,
        const_range: Tuple[float, float] = (-5.0, 5.0),
        seed: int = 0,
    ):
        for op in binary_operators:
            if op not in _BINARY:
                raise ValueError(f"unknown binary op {op!r}")
        for op in unary_operators:
            if op not in _UNARY:
                raise ValueError(f"unknown unary op {op!r}")
        self.binary = list(binary_operators)
        self.unary = list(unary_operators)
        self.populations = populations
        self.population_size = population_size
        self.niterations = niterations
        self.evolutions = evolutions_per_iteration
        self.max_complexity = max_complexity
        self.parsimony = parsimony
        self.tournament = tournament
        self.batch_size = batch_size
        self.const_range = const_range
        self.seed = seed
        self.equations_: List[Equation] = []

    # -- random tree construction -------------------------------------------
    def _rand_leaf(self, rng, n_vars: int) -> Node:
        if rng.random() < 0.6:
            return Node(var=int(rng.integers(n_vars)))
        lo, hi = self.const_range
        return Node(value=float(rng.uniform(lo, hi)))

    def _rand_tree(self, rng, n_vars: int, depth: int) -> Node:
        if depth <= 0 or rng.random() < 0.3:
            return self._rand_leaf(rng, n_vars)
        ops = self.binary + self.unary
        op = ops[int(rng.integers(len(ops)))]
        if op in _BINARY:
            return Node(op, self._rand_tree(rng, n_vars, depth - 1),
                        self._rand_tree(rng, n_vars, depth - 1))
        return Node(op, self._rand_tree(rng, n_vars, depth - 1))

    # -- fitness --------------------------------------------------------------
    @staticmethod
    def _mse(tree: Node, X: np.ndarray, y: np.ndarray) -> float:
        try:
            pred = tree(X)
        except Exception:
            return float("inf")
        if not np.all(np.isfinite(pred)):
            return float("inf")
        return float(np.mean((pred - y) ** 2))

    def _fitness(self, tree: Node, X: np.ndarray, y: np.ndarray) -> float:
        c = tree.complexity()
        if c > self.max_complexity:
            return float("inf")
        return self._mse(tree, X, y) * (1.0 + self.parsimony * c)

    # -- mutation / crossover -------------------------------------------------
    def _mutate(self, rng, tree: Node, n_vars: int) -> Node:
        tree = tree.copy()
        nodes = tree.nodes()
        target = nodes[int(rng.integers(len(nodes)))]
        r = rng.random()
        if r < 0.25:  # perturb or insert constant
            consts = tree.constants()
            if consts:
                c = consts[int(rng.integers(len(consts)))]
                c.value = float(c.value * rng.normal(1.0, 0.3)
                                + rng.normal(0.0, 0.1))
                return tree
            r = 0.95  # no constants: fall through to scale-wrap
        if r < 0.45 and not target.is_leaf():  # swap operator, keep arity
            pool = self.binary if target.right is not None else self.unary
            if pool:
                target.op = pool[int(rng.integers(len(pool)))]
            return tree
        if r < 0.6 and not target.is_leaf():  # hoist: child replaces node
            child = target.left
            target.op, target.left, target.right = child.op, child.left, child.right
            target.value, target.var = child.value, child.var
            return tree
        if r < 0.8:  # subtree replacement
            new = self._rand_tree(rng, n_vars, depth=2)
            target.op, target.left, target.right = new.op, new.left, new.right
            target.value, target.var = new.value, new.var
            return tree
        # wrap target in a constant scale/offset: t -> (c * t) or (t + c)
        inner = Node(target.op, target.left, target.right, target.value,
                     target.var)
        const = Node(value=float(rng.normal(1.0, 1.0)))
        op = "*" if ("*" in self.binary and rng.random() < 0.5
                     or "+" not in self.binary) else "+"
        target.op, target.left, target.right = op, const, inner
        target.value, target.var = None, None
        return tree

    @staticmethod
    def _crossover(rng, a: Node, b: Node) -> Node:
        child = a.copy()
        nodes = child.nodes()
        target = nodes[int(rng.integers(len(nodes)))]
        donors = b.nodes()
        donor = donors[int(rng.integers(len(donors)))].copy()
        target.op, target.left, target.right = donor.op, donor.left, donor.right
        target.value, target.var = donor.value, donor.var
        return child

    # -- constant polish ------------------------------------------------------
    def _polish(self, tree: Node, X: np.ndarray, y: np.ndarray) -> Node:
        consts = tree.constants()
        if not consts:
            return tree
        x0 = np.array([c.value for c in consts])

        def loss(v):
            for c, vi in zip(consts, v):
                c.value = float(vi)
            return self._mse(tree, X, y)

        if _scipy_minimize is not None and len(x0) <= 8:
            res = _scipy_minimize(loss, x0, method="Nelder-Mead",
                                  options={"maxiter": 200, "xatol": 1e-4,
                                           "fatol": 1e-8})
            v = res.x if np.isfinite(res.fun) else x0
        else:  # numpy coordinate hill-climb
            v = x0.copy()
            best = loss(v)
            for _ in range(50):
                improved = False
                for i in range(len(v)):
                    for step in (1.05, 0.95, 1.2, 0.8):
                        trial = v.copy()
                        trial[i] = trial[i] * step + (step - 1.0) * 1e-3
                        lt = loss(trial)
                        if lt < best:
                            best, v, improved = lt, trial, True
                if not improved:
                    break
        loss(v)  # write winners back into the tree
        return tree

    # -- main loop --------------------------------------------------------------
    def fit(self, X: np.ndarray, y: np.ndarray) -> "GPSymbolicRegressor":
        X = np.asarray(X, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64).ravel()
        if X.ndim != 2 or X.shape[0] != y.shape[0]:
            raise ValueError("X must be (n, d) with matching y")
        n_vars = X.shape[1]
        rng = np.random.default_rng(self.seed)

        # search on a fixed subsample (PySR batching); final table on full data
        if X.shape[0] > self.batch_size:
            idx = rng.choice(X.shape[0], self.batch_size, replace=False)
            Xb, yb = X[idx], y[idx]
        else:
            Xb, yb = X, y

        islands = []
        for _ in range(self.populations):
            pop = [self._rand_tree(rng, n_vars, depth=3)
                   for _ in range(self.population_size)]
            fit = [self._fitness(t, Xb, yb) for t in pop]
            islands.append((pop, fit))

        # hall of fame on batch loss (complexity -> (batch_mse, tree));
        # final table re-scores on the full data after a last polish
        hof: Dict[int, Tuple[float, Node]] = {}

        def record(tree: Node, batch_mse: Optional[float] = None):
            c = tree.complexity()
            if batch_mse is None:
                batch_mse = self._mse(tree, Xb, yb)
            if math.isfinite(batch_mse) and (c not in hof
                                             or batch_mse < hof[c][0]):
                hof[c] = (batch_mse, tree.copy())

        for it in range(self.niterations):
            for pop, fit in islands:
                for _ in range(self.evolutions):
                    # tournament pick
                    cand = rng.integers(len(pop), size=self.tournament)
                    i = int(cand[int(np.argmin([fit[j] for j in cand]))])
                    if rng.random() < 0.7:
                        j = int(rng.integers(len(pop)))
                        child = self._crossover(rng, pop[i], pop[j])
                    else:
                        child = self._mutate(rng, pop[i], n_vars)
                    if rng.random() < 0.03:  # occasional constant polish
                        child = self._polish(child, Xb, yb)
                    f = self._fitness(child, Xb, yb)
                    # derive the batch mse from the fitness (one tree
                    # evaluation per candidate, not two)
                    c = child.complexity()
                    record(child, f / (1.0 + self.parsimony * c)
                           if math.isfinite(f) else float("inf"))
                    # steady-state: replace a tournament loser
                    cand = rng.integers(len(pop), size=self.tournament)
                    w = int(cand[int(np.argmax([fit[j] for j in cand]))])
                    if f <= fit[w]:
                        pop[w], fit[w] = child, f
            # polish + record island champions, then migrate them
            champs = []
            for pop, fit in islands:
                b = int(np.argmin(fit))
                pop[b] = self._polish(pop[b], Xb, yb)
                fit[b] = self._fitness(pop[b], Xb, yb)
                record(pop[b])
                champs.append(pop[b])
            for k, (pop, fit) in enumerate(islands):
                donor = champs[(k + 1) % len(champs)].copy()
                r = int(rng.integers(len(pop)))
                pop[r], fit[r] = donor, self._fitness(donor, Xb, yb)

        # final pass: polish every front entry, re-score on the FULL data
        final: Dict[int, Tuple[float, Node]] = {}
        for c, (_, tree) in sorted(hof.items()):
            tree = self._polish(tree, Xb, yb)
            c2 = tree.complexity()
            loss = self._mse(tree, X, y)
            if math.isfinite(loss) and (c2 not in final or loss < final[c2][0]):
                final[c2] = (loss, tree)

        # pareto table with PySR-style scores
        rows = sorted(final.items())
        eqs: List[Equation] = []
        prev_loss, prev_c = None, None
        best_so_far = float("inf")
        for c, (loss, tree) in rows:
            if loss >= best_so_far:  # keep the front monotone
                continue
            best_so_far = loss
            if prev_loss is None or loss <= 0:
                score = 0.0
            else:
                score = (math.log(prev_loss + 1e-30) - math.log(loss + 1e-30)) \
                    / max(c - prev_c, 1)
            eqs.append(Equation(c, loss, score, str(tree), tree))
            prev_loss, prev_c = loss, c
        self.equations_ = eqs
        return self

    # -- selection ----------------------------------------------------------
    def best(self) -> Equation:
        """PySR 'best' model selection: among equations with loss within
        1.5x of the minimum, pick the highest score."""
        if not self.equations_:
            raise RuntimeError("fit() first")
        min_loss = min(e.loss for e in self.equations_)
        thr = max(1.5 * min_loss, min_loss + 1e-12)
        near = [e for e in self.equations_ if e.loss <= thr]
        return max(near, key=lambda e: e.score)

    def predict(self, X: np.ndarray) -> np.ndarray:
        return self.best().predict(X)
