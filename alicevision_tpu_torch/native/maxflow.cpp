// Max-flow / min-cut for the graph-cut surface mesher (mesh/delaunay_graphcut.py).
//
// Port of `bk_maxflow` in alicevision_tpu/native/tracks_native.cpp (ref:
// src/aliceVision/fuseCut/MaxFlow_AdjList.hpp on boost BGL): the same
// algorithm, arc layout and tolerances, so both packages cut a graph the
// same way. The union-find half of that file is not carried over; the
// port's tracks use their own (tracks/builder.py).
//
// Built at first use with the system C++ compiler by native/__init__.py and
// called through ctypes (plain C interface).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <queue>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Max-flow / min-cut under the reference's name `bk_maxflow`; the body is
// Dinic's algorithm on CSR arcs (the history below is the reference's).
// Graph: n nodes + implicit source/sink via terminal capacities.
//   tcap[i] > 0: source->i capacity; tcap[i] < 0: i->sink capacity.
//   edges: (u, v, cap, rev_cap) pairs.
// Returns max flow; out_label[i] = 1 if i on the SOURCE side of the cut.
// ---------------------------------------------------------------------------

double bk_maxflow(int64_t n_nodes, const int64_t* eu, const int64_t* ev,
                  const double* ecap, const double* erev, int64_t n_edges,
                  const double* tcap_in, uint8_t* out_label) {
    // Dinic's algorithm with explicit super-source/super-sink, CSR arc
    // storage.
    //
    // History: Edmonds-Karp (full BFS per path) took ~13 min on a
    // 316k-cell meshing graph; the round-4 Dinic on LINKED-LIST arcs cut
    // that to seconds but went superlinear at millions of cells (117 s at
    // 3.1M cells / 12.5M arcs — every BFS/DFS step chases a `next`
    // pointer across a 300 MB heap). This round stores arcs in CSR order
    // (each node's arcs contiguous, `mate[]` cross-links the residual
    // pair), turning the traversals into linear scans.
    const int64_t S = n_nodes;      // super source
    const int64_t T = n_nodes + 1;  // super sink
    const int64_t N = n_nodes + 2;

    // --- degree count ------------------------------------------------------
    std::vector<int64_t> off(N + 1, 0);
    auto deg = [&](int64_t u) -> int64_t& { return off[u + 1]; };
    for (int64_t e = 0; e < n_edges; ++e) {
        if (eu[e] < 0 || eu[e] >= n_nodes || ev[e] < 0 || ev[e] >= n_nodes)
            continue;  // defend the heap against malformed edge lists
        deg(eu[e])++;
        deg(ev[e])++;
    }
    for (int64_t i = 0; i < n_nodes; ++i) {
        if (tcap_in[i] > 1e-12) {
            deg(S)++;
            deg(i)++;
        } else if (tcap_in[i] < -1e-12) {
            deg(i)++;
            deg(T)++;
        }
    }
    for (int64_t i = 0; i < N; ++i) off[i + 1] += off[i];
    const int64_t M = off[N];

    std::vector<int32_t> head(M);
    std::vector<int32_t> mate(M);
    std::vector<double> rcap(M);
    std::vector<int64_t> cur(off.begin(), off.end() - 1);
    auto add_pair = [&](int64_t u, int64_t v, double c, double cr) {
        int64_t ia = cur[u]++;
        int64_t ib = cur[v]++;
        head[ia] = (int32_t)v;
        rcap[ia] = c;
        mate[ia] = (int32_t)ib;
        head[ib] = (int32_t)u;
        rcap[ib] = cr;
        mate[ib] = (int32_t)ia;
    };
    for (int64_t e = 0; e < n_edges; ++e) {
        if (eu[e] < 0 || eu[e] >= n_nodes || ev[e] < 0 || ev[e] >= n_nodes)
            continue;
        add_pair(eu[e], ev[e], ecap[e], erev[e]);
    }
    for (int64_t i = 0; i < n_nodes; ++i) {
        if (tcap_in[i] > 1e-12)
            add_pair(S, i, tcap_in[i], 0.0);
        else if (tcap_in[i] < -1e-12)
            add_pair(i, T, -tcap_in[i], 0.0);
    }

    std::vector<int32_t> level(N);
    std::vector<int64_t> it(N);
    std::vector<int32_t> bfs_q(N);

    auto bfs = [&]() -> bool {
        std::fill(level.begin(), level.end(), -1);
        int32_t qhead = 0, qtail = 0;
        bfs_q[qtail++] = (int32_t)S;
        level[S] = 0;
        while (qhead < qtail) {
            int32_t u = bfs_q[qhead++];
            for (int64_t ai = off[u]; ai < off[u + 1]; ++ai) {
                int32_t v = head[ai];
                if (rcap[ai] > 1e-12 && level[v] < 0) {
                    level[v] = level[u] + 1;
                    bfs_q[qtail++] = v;
                }
            }
        }
        return level[T] >= 0;
    };

    // Iterative blocking-flow DFS with current-arc pointers.
    std::vector<int64_t> path_arc;
    path_arc.reserve(1024);
    double flow = 0.0;
    while (bfs()) {
        for (int64_t i = 0; i < N; ++i) it[i] = off[i];
        for (;;) {
            // walk from S following admissible current arcs
            path_arc.clear();
            int64_t u = S;
            while (u != T) {
                int64_t ai = it[u];
                const int64_t aend = off[u + 1];
                while (ai < aend &&
                       (rcap[ai] <= 1e-12 || level[head[ai]] != level[u] + 1))
                    ++ai;
                it[u] = ai;
                if (ai == aend) {
                    // dead end: retreat (or phase done at S)
                    if (path_arc.empty()) {
                        u = -1;
                        break;
                    }
                    level[u] = -1;  // prune exhausted node this phase
                    int64_t pa = path_arc.back();
                    path_arc.pop_back();
                    u = head[mate[pa]];  // tail of pa
                    it[u] = pa + 1;      // skip the arc into the dead node
                    continue;
                }
                path_arc.push_back(ai);
                u = head[ai];
            }
            if (u == -1) break;  // no more augmenting paths this phase
            // bottleneck + augment
            double bn = rcap[path_arc[0]];
            for (int64_t pa : path_arc) bn = std::min(bn, rcap[pa]);
            for (int64_t pa : path_arc) {
                rcap[pa] -= bn;
                rcap[mate[pa]] += bn;
            }
            flow += bn;
        }
    }

    // Reachability from S in the residual graph = source side of the cut.
    std::vector<uint8_t> visited(N, 0);
    std::queue<int32_t> q2;
    q2.push((int32_t)S);
    visited[S] = 1;
    while (!q2.empty()) {
        int32_t u = q2.front();
        q2.pop();
        for (int64_t ai = off[u]; ai < off[u + 1]; ++ai) {
            if (rcap[ai] > 1e-12 && !visited[head[ai]]) {
                visited[head[ai]] = 1;
                q2.push(head[ai]);
            }
        }
    }
    std::memcpy(out_label, visited.data(), n_nodes);
    return flow;
}

}  // extern "C"
