"""TSP / VRP → Ising encoders (reference problems/routing.py:35-677).

TSP uses the position encoding x_{city,pos} (n^2 spins): tour length becomes
binary-quadratic couplings between consecutive positions
(routing.py:275-294), plus cardinality-1 constraints per city and per position
(routing.py:296-328) with the reference's sqrt(n/50) penalty auto-scaling for
n > 50 (routing.py:237-241). All terms are generated vectorized and scattered
once.

VRP uses x_{customer,pos,vehicle} route-position encoding (n*P*K spins):
per-vehicle tours through assigned positions, each customer served exactly
once, depot implicit at route ends (a more compact reformulation of the
reference's arc encoding x_{i,j,k}, routing.py:416-569 — same capability,
quadratically fewer spins than n^2*K arcs)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from spinglass_tpu.core import constraints as C
from spinglass_tpu.core.problem import IsingProblem
from spinglass_tpu.problems.base import ProblemSolution, ProblemTemplate, spins_to_binary


def distance_matrix(locations: np.ndarray, metric: str = "euclidean") -> np.ndarray:
    """O(n^2) vectorized distances (reference routing.py:244-269)."""
    loc = np.asarray(locations, dtype=np.float64)
    diff = loc[:, None, :] - loc[None, :, :]
    if metric == "euclidean":
        return np.sqrt((diff ** 2).sum(-1))
    if metric == "manhattan":
        return np.abs(diff).sum(-1)
    if metric == "chebyshev":
        return np.abs(diff).max(-1)
    raise ValueError(metric)


class TSPProblem(ProblemTemplate):
    """Traveling salesman (reference routing.py:183-403)."""

    name = "tsp"

    def __init__(self, locations: Optional[np.ndarray] = None,
                 distances: Optional[np.ndarray] = None,
                 metric: str = "euclidean"):
        super().__init__()
        self.locations = None if locations is None else np.asarray(locations)
        self.metric = metric
        self._distances = distances

    def generate_random_instance(self, n_cities: int = 10, seed: int = 0,
                                 box: float = 100.0) -> None:
        rng = np.random.default_rng(seed)
        self.locations = rng.uniform(0, box, (n_cities, 2))
        self._distances = None

    @property
    def n_cities(self) -> int:
        if self._distances is not None:
            return self._distances.shape[0]
        return len(self.locations)

    @property
    def distances(self) -> np.ndarray:
        if self._distances is None:
            self._distances = distance_matrix(self.locations, self.metric)
        return self._distances

    def spin_index(self, city: int, pos: int) -> int:
        return city * self.n_cities + pos

    def encode_to_ising(self, penalty_weight: Optional[float] = None,
                        **params) -> IsingProblem:
        n = self.n_cities
        d = self.distances
        if penalty_weight is None:
            # strong enough to dominate tour-length gains, auto-scaled like
            # reference routing.py:237-241
            penalty_weight = 2.0 * float(d.max()) * max(1.0, np.sqrt(n / 50.0))

        # objective: sum_p sum_{c1 != c2} d[c1,c2] x[c1,p] x[c2,(p+1)%n]
        c1, c2, p = np.meshgrid(np.arange(n), np.arange(n), np.arange(n),
                                indexing="ij")
        off = c1 != c2
        qi = (c1 * n + p)[off].ravel()
        qj = (c2 * n + (p + 1) % n)[off].ravel()
        qv = np.broadcast_to(d[:, :, None], (n, n, n))[off].ravel()
        obj = C.binary_quadratic_terms(qi, qj, qv)

        self.compiler = C.ConstraintCompiler()
        for city in range(n):
            idx = city * n + np.arange(n)
            self.compiler.add(C.CardinalityConstraint(
                name=f"city_{city}_once", indices=idx, k=1,
                weight=penalty_weight))
        for pos in range(n):
            idx = np.arange(n) * n + pos
            self.compiler.add(C.CardinalityConstraint(
                name=f"pos_{pos}_once", indices=idx, k=1,
                weight=penalty_weight))
        t = C.Terms.concat([obj, self.compiler.compile()])
        self._problem = IsingProblem.from_terms(
            n * n, t.quad_i, t.quad_j, t.quad_v, t.lin_i, t.lin_v)
        return self._problem

    def tour_length(self, tour: np.ndarray) -> float:
        d = self.distances
        return float(d[tour, np.roll(tour, -1)].sum())

    def decode_solution(self, spins: np.ndarray) -> ProblemSolution:
        """Greedy-repair decode (reference routing.py:330-403): per position
        pick the assigned city; duplicate/missing cities repaired greedily."""
        n = self.n_cities
        x = spins_to_binary(spins)[: n * n].reshape(n, n)  # [city, pos]
        raw_violations = self.compiler.violation_report(np.asarray(spins)[: n * n])
        tour = np.full(n, -1, dtype=np.int64)
        used = np.zeros(n, dtype=bool)
        for pos in range(n):
            cands = np.nonzero(x[:, pos])[0]
            cands = [c for c in cands if not used[c]]
            if cands:
                tour[pos] = cands[0]
                used[cands[0]] = True
        missing = [c for c in range(n) if not used[c]]
        for pos in range(n):
            if tour[pos] < 0:
                tour[pos] = missing.pop(0)
        length = self.tour_length(tour)
        clean = bool(np.all(x.sum(axis=0) == 1) and np.all(x.sum(axis=1) == 1))
        return ProblemSolution(
            objective_value=length,
            variables={"tour": tour, "assignment": x},
            is_feasible=True,  # repaired tour is always valid
            constraint_violations=raw_violations,
            metadata={"clean_decode": clean},
        )

    def validate_tour(self, tour: np.ndarray) -> bool:
        return sorted(np.asarray(tour).tolist()) == list(range(self.n_cities))


@dataclass
class Vehicle:
    capacity: float = float("inf")


class VRPProblem(ProblemTemplate):
    """Capacitated vehicle routing (reference routing.py:406-677).

    Encoding: x[c, p, k] — customer c is the p-th stop of vehicle k's route
    (P positions per vehicle). Each vehicle leaves/returns to the depot
    (node 0). n_spins = n_customers * P * K."""

    name = "vrp"

    def __init__(self, locations: Optional[np.ndarray] = None,
                 demands: Optional[np.ndarray] = None,
                 n_vehicles: int = 2, capacity: float = float("inf"),
                 route_len: Optional[int] = None):
        super().__init__()
        self.locations = None if locations is None else np.asarray(locations)
        self.demands = None if demands is None else np.asarray(demands)
        self.n_vehicles = n_vehicles
        self.capacity = capacity
        self.route_len = route_len
        self._distances = None

    def generate_random_instance(self, n_customers: int = 8, n_vehicles: int = 2,
                                 seed: int = 0, box: float = 100.0,
                                 capacity: float = 0.0) -> None:
        rng = np.random.default_rng(seed)
        # node 0 is the depot
        self.locations = rng.uniform(0, box, (n_customers + 1, 2))
        self.demands = rng.uniform(1, 10, n_customers)
        self.n_vehicles = n_vehicles
        self.capacity = capacity if capacity > 0 else (
            1.6 * self.demands.sum() / n_vehicles)
        self._distances = None

    @property
    def n_customers(self) -> int:
        return len(self.locations) - 1

    @property
    def distances(self) -> np.ndarray:
        if self._distances is None:
            self._distances = distance_matrix(self.locations)
        return self._distances

    def _dims(self):
        n = self.n_customers
        k = self.n_vehicles
        p = self.route_len or int(np.ceil(n / k)) + 1
        return n, p, k

    def spin_index(self, c: int, p: int, k: int) -> int:
        n, pp, kk = self._dims()
        return (c * pp + p) * kk + k

    def encode_to_ising(self, penalty_weight: Optional[float] = None,
                        **params) -> IsingProblem:
        n, pp, kk = self._dims()
        d = self.distances  # [n+1, n+1], row/col 0 = depot
        if penalty_weight is None:
            penalty_weight = 2.0 * float(d.max()) * max(1.0, np.sqrt(n / 50.0))
        n_spins = n * pp * kk

        # travel cost: depot->first stop, consecutive stops, last->depot is
        # approximated by depot links on every position boundary when adjacent
        # positions are empty — we charge: depot->c for p=0, c1->c2 for
        # consecutive (p, p+1) same vehicle, c->depot for p=P-1.
        qi_l, qj_l, qv_l, li_l, lv_l = [], [], [], [], []
        cs = np.arange(n)
        for k in range(kk):
            # linear: depot legs
            li_l.append(np.array([self.spin_index(c, 0, k) for c in cs]))
            lv_l.append(d[0, 1:][cs])
            li_l.append(np.array([self.spin_index(c, pp - 1, k) for c in cs]))
            lv_l.append(d[1:, 0][cs])
            # quadratic: consecutive stops
            for p in range(pp - 1):
                c1, c2 = np.meshgrid(cs, cs, indexing="ij")
                off = c1 != c2
                qi_l.append(np.array(
                    [(a * pp + p) * kk + k for a in c1[off].ravel()]))
                qj_l.append(np.array(
                    [(b * pp + p + 1) * kk + k for b in c2[off].ravel()]))
                qv_l.append(d[1:, 1:][c1[off], c2[off]].ravel())
        obj = C.binary_quadratic_terms(
            np.concatenate(qi_l), np.concatenate(qj_l), np.concatenate(qv_l),
            np.concatenate(li_l), np.concatenate(lv_l))

        self.compiler = C.ConstraintCompiler()
        # each customer served exactly once (over all positions/vehicles)
        for c in range(n):
            idx = np.array([self.spin_index(c, p, k)
                            for p in range(pp) for k in range(kk)])
            self.compiler.add(C.CardinalityConstraint(
                name=f"cust_{c}_once", indices=idx, k=1,
                weight=penalty_weight))
        # each (position, vehicle) slot holds at most one customer:
        # inequality via cardinality toward 0/1 — use soft pairwise penalty
        for k in range(kk):
            for p in range(pp):
                idx = np.array([self.spin_index(c, p, k) for c in range(n)])
                # penalize pairs: sum over pairs x_i x_j  (0 when <=1 chosen)
                iu, ju = np.triu_indices(n, k=1)
                self.compiler.add(C.CustomConstraint(
                    name=f"slot_{k}_{p}_unique", weight=penalty_weight,
                    terms_fn=lambda idx=idx, iu=iu, ju=ju: C.binary_quadratic_terms(
                        idx[iu], idx[ju], np.full(len(iu), 2.0)),
                    violation_fn=lambda s, idx=idx: max(
                        0.0, float((np.asarray(s)[idx] > 0).sum() - 1)),
                ))
        t = C.Terms.concat([obj, self.compiler.compile()])
        self._problem = IsingProblem.from_terms(
            n_spins, t.quad_i, t.quad_j, t.quad_v, t.lin_i, t.lin_v)
        return self._problem

    def decode_solution(self, spins: np.ndarray) -> ProblemSolution:
        n, pp, kk = self._dims()
        x = spins_to_binary(spins)[: n * pp * kk].reshape(n, pp, kk)
        routes = {k: [] for k in range(kk)}
        served = np.zeros(n, dtype=bool)
        for k in range(kk):
            for p in range(pp):
                cands = [c for c in np.nonzero(x[:, p, k])[0] if not served[c]]
                if cands:
                    routes[k].append(int(cands[0]))
                    served[cands[0]] = True
        # greedy repair: unserved customers to least-loaded vehicle
        for c in np.nonzero(~served)[0]:
            k = min(routes, key=lambda kk_: len(routes[kk_]))
            routes[k].append(int(c))
        d = self.distances
        total, loads = 0.0, {}
        for k, route in routes.items():
            load = float(self.demands[route].sum()) if route else 0.0
            loads[k] = load
            if route:
                nodes = [0] + [c + 1 for c in route] + [0]
                total += float(sum(d[a, b] for a, b in zip(nodes, nodes[1:])))
        feasible = all(l <= self.capacity + 1e-9 for l in loads.values())
        return ProblemSolution(
            objective_value=total,
            variables={"routes": routes, "loads": loads},
            is_feasible=feasible,
            constraint_violations={
                f"vehicle_{k}_overload": max(0.0, l - self.capacity)
                for k, l in loads.items()},
        )


class VRPArcProblem(ProblemTemplate):
    """Arc-based capacitated VRP — the reference's exact encoding
    (routing.py:416-569): x[i, j, k] = 1 iff vehicle k travels arc i -> j,
    n_spins = L^2 * K (L locations incl. depot 0), with all four constraint
    families:

    * customer service — each customer has exactly one incoming arc over all
      origins and vehicles (routing.py:492-516, cardinality-1)
    * vehicle flow — per (vehicle, location): incoming == outgoing
      (routing.py:518-546, +-1-weighted equality)
    * capacity — customers whose demand exceeds a vehicle's capacity are
      excluded from that vehicle via arc field penalties (routing.py:548-571;
      the reference's own comment notes full route-load tracking needs
      cumulative state), PLUS a route-load soft penalty the reference lacks:
      slack-register inequality sum_c d_c y_ck <= capacity with binary slack
      bits, so overloads are penalized quadratically instead of only the
      single-customer case
    * depot — each vehicle uses exactly one depot-departure arc
      (routing.py:573-588, cardinality-1)

    Self-arcs x[i, i, k] are suppressed with field penalties. All terms are
    built vectorized and scattered once (no per-coupling set_coupling calls).
    The position-based ``VRPProblem`` above stays the more compact default
    (quadratically fewer spins); this class is the reference-parity encoding.
    """

    name = "vrp_arc"

    def __init__(self, locations: Optional[np.ndarray] = None,
                 demands: Optional[np.ndarray] = None,
                 n_vehicles: int = 2, capacity: float = float("inf")):
        super().__init__()
        self.locations = None if locations is None else np.asarray(locations)
        self.demands = None if demands is None else np.asarray(demands)
        self.n_vehicles = n_vehicles
        self.capacity = capacity
        self._distances = None

    def generate_random_instance(self, n_customers: int = 5,
                                 n_vehicles: int = 2, seed: int = 0,
                                 box: float = 100.0,
                                 capacity: float = 0.0) -> None:
        rng = np.random.default_rng(seed)
        self.locations = rng.uniform(0, box, (n_customers + 1, 2))
        self.demands = rng.uniform(1, 10, n_customers)
        self.n_vehicles = n_vehicles
        self.capacity = capacity if capacity > 0 else (
            1.6 * self.demands.sum() / n_vehicles)
        self._distances = None

    @property
    def n_locations(self) -> int:
        return len(self.locations)

    @property
    def distances(self) -> np.ndarray:
        if self._distances is None:
            self._distances = distance_matrix(self.locations)
        return self._distances

    def spin_index(self, i: int, j: int, k: int) -> int:
        ll, kk = self.n_locations, self.n_vehicles
        return (i * ll + j) * kk + k

    def _arc_grid(self):
        ll, kk = self.n_locations, self.n_vehicles
        i, j, k = np.meshgrid(np.arange(ll), np.arange(ll), np.arange(kk),
                              indexing="ij")
        return i.ravel(), j.ravel(), k.ravel()

    def encode_to_ising(self, penalty_weights: Optional[dict] = None,
                        n_slack_bits: int = 3, **params) -> IsingProblem:
        ll, kk = self.n_locations, self.n_vehicles
        d = self.distances
        if penalty_weights is None:
            scale = 2.0 * float(d.max())
            penalty_weights = {
                "customer_service": scale,
                "vehicle_flow": scale,
                "capacity": 0.5 * scale,
                "depot_return": 0.75 * scale,
            }
        n_arcs = ll * ll * kk
        # slack registers: per vehicle, n_slack_bits binary bits encoding the
        # unused capacity for the route-load inequality
        n_spins = n_arcs + kk * n_slack_bits

        # objective: distance on every used arc (reference routing.py:476-490)
        i, j, k = self._arc_grid()
        idx = (i * ll + j) * kk + k
        off = i != j
        obj = C.binary_quadratic_terms(
            np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0),
            idx[off], d[i[off], j[off]])
        # suppress self-arcs
        self_pen = C.binary_quadratic_terms(
            np.zeros(0, np.int64), np.zeros(0, np.int64), np.zeros(0),
            idx[~off], np.full((~off).sum(), 10.0 * float(d.max())))

        self.compiler = C.ConstraintCompiler()
        w = penalty_weights

        # (1) customer service: one incoming arc per customer
        for c in range(1, ll):
            inc = np.array([self.spin_index(i2, c, k2)
                            for i2 in range(ll) if i2 != c
                            for k2 in range(kk)])
            self.compiler.add(C.CardinalityConstraint(
                name=f"customer_{c}_served", indices=inc, k=1,
                weight=w["customer_service"]))

        # (2) vehicle flow conservation: in == out per (vehicle, location).
        # |in| == |out| and the coefficients sum to zero, so the binary
        # balance equals the spin balance with weight lam/4.
        for k2 in range(kk):
            for loc in range(ll):
                inc = np.array([self.spin_index(i2, loc, k2)
                                for i2 in range(ll) if i2 != loc])
                out = np.array([self.spin_index(loc, j2, k2)
                                for j2 in range(ll) if j2 != loc])
                self.compiler.add(C.EqualityConstraint(
                    name=f"flow_k{k2}_l{loc}",
                    indices=np.concatenate([inc, out]),
                    coeffs=np.concatenate([np.ones(len(inc)),
                                           -np.ones(len(out))]),
                    target=0.0,
                    weight=w["vehicle_flow"] / 4.0))

        # (3a) capacity exclusion (reference parity): demand > capacity
        # means no incoming arcs for that (customer, vehicle)
        cap_excl_i, cap_excl_v = [], []
        for k2 in range(kk):
            for c in range(1, ll):
                if self.demands[c - 1] > self.capacity:
                    for i2 in range(ll):
                        if i2 != c:
                            cap_excl_i.append(self.spin_index(i2, c, k2))
                            cap_excl_v.append(w["capacity"])
        if cap_excl_i:
            self.compiler.add(C.CustomConstraint(
                name="capacity_exclusion", weight=1.0,
                terms_fn=lambda ii=np.array(cap_excl_i, np.int64),
                vv=np.array(cap_excl_v): C.binary_quadratic_terms(
                    np.zeros(0, np.int64), np.zeros(0, np.int64),
                    np.zeros(0), ii, vv),
                violation_fn=lambda s, ii=np.array(cap_excl_i, np.int64):
                float((np.asarray(s)[ii] > 0).sum())))

        # (3b) route-load inequality via binary slack register (beyond the
        # reference): sum_c d_c * served_by_k(c) + slack = capacity, slack in
        # [0, 2^B - 1] scaled to the capacity range. served_by_k(c) is the
        # incoming-arc indicator sum.
        if np.isfinite(self.capacity) and n_slack_bits > 0:
            slack_unit = self.capacity / (2 ** n_slack_bits - 1)
            for k2 in range(kk):
                idx_l, coef_l = [], []
                for c in range(1, ll):
                    for i2 in range(ll):
                        if i2 != c:
                            idx_l.append(self.spin_index(i2, c, k2))
                            coef_l.append(float(self.demands[c - 1]))
                for b in range(n_slack_bits):
                    idx_l.append(n_arcs + k2 * n_slack_bits + b)
                    coef_l.append(slack_unit * (2 ** b))
                # binary equality sum c_i x_i = capacity -> spin space:
                # sum (c_i/2) s_i = capacity - sum(c_i)/2
                coefs = np.asarray(coef_l) / 2.0
                target = self.capacity - np.asarray(coef_l).sum() / 2.0
                self.compiler.add(C.EqualityConstraint(
                    name=f"capacity_load_k{k2}",
                    indices=np.asarray(idx_l, np.int64), coeffs=coefs,
                    target=target, weight=w["capacity"]
                    / max(float(self.demands.max()) ** 2, 1.0)))

        # (4) depot departure: exactly one outgoing depot arc per vehicle
        for k2 in range(kk):
            dep = np.array([self.spin_index(0, j2, k2)
                            for j2 in range(1, ll)])
            self.compiler.add(C.CardinalityConstraint(
                name=f"depot_departure_k{k2}", indices=dep, k=1,
                weight=w["depot_return"]))

        t = C.Terms.concat([obj, self_pen, self.compiler.compile()])
        self._problem = IsingProblem.from_terms(
            n_spins, t.quad_i, t.quad_j, t.quad_v, t.lin_i, t.lin_v)
        return self._problem

    def decode_solution(self, spins: np.ndarray) -> ProblemSolution:
        """Follow arcs from the depot per vehicle (reference
        routing.py:590-661)."""
        ll, kk = self.n_locations, self.n_vehicles
        x = spins_to_binary(spins)[: ll * ll * kk].reshape(ll, ll, kk)
        d = self.distances
        routes, total = [], 0.0
        for k in range(kk):
            route, cur, visited = [0], 0, {0}
            for _ in range(ll):
                nxt = None
                for j in range(ll):
                    if j != cur and x[cur, j, k] == 1:
                        nxt = j
                        break
                if nxt is None:
                    break
                total += d[cur, nxt]
                if nxt == 0 or nxt in visited:
                    route.append(0)
                    break
                route.append(nxt)
                visited.add(nxt)
                cur = nxt
            if len(route) > 1:
                routes.append(route)
        served = {loc for r in routes for loc in r if loc > 0}
        unserved = set(range(1, ll)) - served
        loads = {}
        for k, r in enumerate(routes):
            loads[k] = float(sum(self.demands[c - 1] for c in r if c > 0))
        overload = {k: max(0.0, l - self.capacity) for k, l in loads.items()}
        feasible = not unserved and all(v <= 1e-9 for v in overload.values())
        return ProblemSolution(
            objective_value=total,
            variables={"routes": routes, "loads": loads},
            is_feasible=feasible,
            constraint_violations={
                "unserved_customers": float(len(unserved)),
                **{f"vehicle_{k}_overload": v for k, v in overload.items()},
            },
            metadata={"n_routes": len(routes),
                      "served_customers": len(served)},
        )

    def validate_solution(self, solution: ProblemSolution) -> bool:
        """All customers served (reference routing.py:663-677)."""
        served = {loc for r in solution.variables["routes"] for loc in r
                  if loc > 0}
        return served == set(range(1, self.n_locations))
