// Native radix index over chained KV block hashes.
//
// The router-hot-path twin of dynamo_tpu/llm/kv_router/indexer.py (behavioral
// spec lives there; reference design: lib/llm/src/kv_router/indexer.rs radix
// tree + single-writer event loop).  Because block hashes chain their
// parents, each node is uniquely addressed by hash; matching walks the
// request's hash sequence intersecting worker sets.
//
// C ABI for ctypes; single-threaded by construction (the indexer event loop
// is the only writer, matching the reference's concurrency design).
//
// Build: g++ -O2 -std=c++17 -shared -fPIC radix_index.cpp -o libradix_index.so

#include <cstdint>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace {

struct Node {
    uint64_t parent = 0;
    bool has_parent = false;
    std::unordered_set<uint64_t> children;
    std::unordered_set<int64_t> workers;
};

struct Tree {
    std::unordered_map<uint64_t, Node> nodes;
    std::unordered_map<int64_t, std::unordered_set<uint64_t>> worker_blocks;

    void prune(uint64_t hash) {
        auto it = nodes.find(hash);
        if (it == nodes.end()) return;
        if (!it->second.workers.empty() || !it->second.children.empty()) return;
        uint64_t parent = it->second.parent;
        bool has_parent = it->second.has_parent;
        nodes.erase(it);
        if (has_parent) {
            auto pit = nodes.find(parent);
            if (pit != nodes.end()) {
                pit->second.children.erase(hash);
                prune(parent);
            }
        }
    }

    void remove_worker_block(int64_t worker, uint64_t hash) {
        auto it = nodes.find(hash);
        if (it == nodes.end()) return;
        it->second.workers.erase(worker);
        auto wit = worker_blocks.find(worker);
        if (wit != worker_blocks.end()) wit->second.erase(hash);
        prune(hash);
    }
};

}  // namespace

extern "C" {

void* radix_new() { return new Tree(); }

void radix_free(void* handle) { delete static_cast<Tree*>(handle); }

void radix_apply_stored(void* handle, int64_t worker, const uint64_t* hashes,
                        int32_t n, uint64_t parent, int32_t has_parent) {
    Tree* tree = static_cast<Tree*>(handle);
    uint64_t prev = parent;
    bool prev_valid = has_parent != 0;
    for (int32_t i = 0; i < n; ++i) {
        uint64_t h = hashes[i];
        auto [it, inserted] = tree->nodes.try_emplace(h);
        if (inserted) {
            it->second.parent = prev;
            it->second.has_parent = prev_valid;
            if (prev_valid) {
                auto pit = tree->nodes.find(prev);
                if (pit != tree->nodes.end()) pit->second.children.insert(h);
            }
        }
        it->second.workers.insert(worker);
        tree->worker_blocks[worker].insert(h);
        prev = h;
        prev_valid = true;
    }
}

void radix_apply_removed(void* handle, int64_t worker, const uint64_t* hashes, int32_t n) {
    Tree* tree = static_cast<Tree*>(handle);
    for (int32_t i = 0; i < n; ++i) tree->remove_worker_block(worker, hashes[i]);
}

void radix_remove_worker(void* handle, int64_t worker) {
    Tree* tree = static_cast<Tree*>(handle);
    auto it = tree->worker_blocks.find(worker);
    if (it == tree->worker_blocks.end()) return;
    std::vector<uint64_t> blocks(it->second.begin(), it->second.end());
    for (uint64_t h : blocks) tree->remove_worker_block(worker, h);
    tree->worker_blocks.erase(worker);
}

// Walk the request's prefix hashes; a worker's score counts only consecutive
// matches.  Results written to (out_workers[i], out_scores[i]); returns count.
int32_t radix_find_matches(void* handle, const uint64_t* hashes, int32_t n,
                           int64_t* out_workers, int32_t* out_scores, int32_t max_out) {
    Tree* tree = static_cast<Tree*>(handle);
    std::unordered_map<int64_t, int32_t> scores;
    std::unordered_set<int64_t> active;
    bool first = true;
    for (int32_t i = 0; i < n; ++i) {
        auto it = tree->nodes.find(hashes[i]);
        if (it == tree->nodes.end() || it->second.workers.empty()) break;
        std::unordered_set<int64_t> holders;
        if (first) {
            holders = it->second.workers;
        } else {
            for (int64_t w : it->second.workers)
                if (active.count(w)) holders.insert(w);
        }
        if (holders.empty()) break;
        for (int64_t w : holders) scores[w] += 1;
        active.swap(holders);
        first = false;
    }
    int32_t count = 0;
    for (const auto& [worker, score] : scores) {
        if (count >= max_out) break;
        out_workers[count] = worker;
        out_scores[count] = score;
        ++count;
    }
    return count;
}

int32_t radix_size(void* handle) {
    return static_cast<int32_t>(static_cast<Tree*>(handle)->nodes.size());
}

int32_t radix_worker_block_count(void* handle, int64_t worker) {
    Tree* tree = static_cast<Tree*>(handle);
    auto it = tree->worker_blocks.find(worker);
    return it == tree->worker_blocks.end() ? 0 : static_cast<int32_t>(it->second.size());
}

}  // extern "C"
