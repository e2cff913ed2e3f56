// dasasim — native host-side navigation-environment engine.
//
// Host-side replacement for the runtime role of the reference C++
// simulator (reference: src/lib/MatterSim.cpp): loads connectivity
// graphs, precomputes all-pairs shortest paths (+ first hop) and the
// 36-view panorama candidate sets, and steps a BATCH of episodes with a
// single call, filling the dense observation arrays the policy
// consumes.  No rendering: training consumes precomputed features
// (reference r2r_src/env.py:60-67 disables rendering too).
//
// Exposed via a C ABI consumed from Python with ctypes
// (dasa_tpu_torch/sim/csim.py).  All geometry matches the Python engine
// (dasa_tpu_torch/sim/engine.py), which is itself conformance-tested against
// the reference's behavioral contracts.

#include <algorithm>
#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <limits>
#include <memory>
#include <queue>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;
constexpr double kTwoPi = 2.0 * kPi;
constexpr int kHeadings = 12;
constexpr int kViews = 36;
constexpr double kHeadingInc = kTwoPi / kHeadings;    // 30 deg
constexpr double kElevationInc = kPi / 6.0;           // 30 deg
// R2R camera: 640x480, 60 deg vfov -> half hfov = 40 deg
// (reference r2r_src/env.py:46-48, utils.py:371-383)
const double kCosHalfHfov =
    std::cos((60.0 * kPi / 180.0) * 640.0 / 480.0 / 2.0);

double wrap_pi(double x) { return std::atan2(std::sin(x), std::cos(x)); }

// ---------------------------------------------------------------------
// Minimal JSON parser (connectivity schema only: arrays, objects,
// strings, numbers, bools, null).
// ---------------------------------------------------------------------
struct JsonValue {
  enum Kind { kNull, kBool, kNumber, kString, kArray, kObject } kind = kNull;
  bool b = false;
  double num = 0.0;
  std::string str;
  std::vector<JsonValue> arr;
  std::vector<std::pair<std::string, JsonValue>> obj;

  const JsonValue* find(const std::string& key) const {
    for (const auto& kv : obj)
      if (kv.first == key) return &kv.second;
    return nullptr;
  }
};

class JsonParser {
 public:
  explicit JsonParser(const std::string& text) : s_(text), i_(0) {}

  JsonValue parse() {
    JsonValue v = value();
    return v;
  }

 private:
  const std::string& s_;
  size_t i_;

  void skip_ws() {
    while (i_ < s_.size() && std::isspace(static_cast<unsigned char>(s_[i_])))
      ++i_;
  }
  char peek() {
    skip_ws();
    return i_ < s_.size() ? s_[i_] : '\0';
  }
  char next() {
    skip_ws();
    return s_[i_++];
  }

  JsonValue value() {
    char c = peek();
    if (c == '{') return object();
    if (c == '[') return array();
    if (c == '"') return string_value();
    if (c == 't' || c == 'f') return bool_value();
    if (c == 'n') {
      i_ += 4;
      return JsonValue{};
    }
    return number();
  }

  JsonValue object() {
    JsonValue v;
    v.kind = JsonValue::kObject;
    next();  // {
    if (peek() == '}') {
      next();
      return v;
    }
    while (true) {
      JsonValue key = string_value();
      next();  // :
      v.obj.emplace_back(key.str, value());
      char c = next();
      if (c == '}') break;
    }
    return v;
  }

  JsonValue array() {
    JsonValue v;
    v.kind = JsonValue::kArray;
    next();  // [
    if (peek() == ']') {
      next();
      return v;
    }
    while (true) {
      v.arr.push_back(value());
      char c = next();
      if (c == ']') break;
    }
    return v;
  }

  JsonValue string_value() {
    JsonValue v;
    v.kind = JsonValue::kString;
    next();  // opening quote
    while (i_ < s_.size()) {
      char c = s_[i_++];
      if (c == '"') break;
      if (c == '\\' && i_ < s_.size()) {
        char e = s_[i_++];
        switch (e) {
          case 'n': v.str += '\n'; break;
          case 't': v.str += '\t'; break;
          case 'r': v.str += '\r'; break;
          case 'u': i_ += 4; v.str += '?'; break;  // ids are ASCII hex
          default: v.str += e;
        }
      } else {
        v.str += c;
      }
    }
    return v;
  }

  JsonValue bool_value() {
    JsonValue v;
    v.kind = JsonValue::kBool;
    if (s_[i_] == 't') {
      v.b = true;
      i_ += 4;
    } else {
      v.b = false;
      i_ += 5;
    }
    return v;
  }

  JsonValue number() {
    JsonValue v;
    v.kind = JsonValue::kNumber;
    skip_ws();
    size_t start = i_;
    while (i_ < s_.size() &&
           (std::isdigit(static_cast<unsigned char>(s_[i_])) ||
            s_[i_] == '-' || s_[i_] == '+' || s_[i_] == '.' ||
            s_[i_] == 'e' || s_[i_] == 'E'))
      ++i_;
    v.num = std::strtod(s_.substr(start, i_ - start).c_str(), nullptr);
    return v;
  }
};

// ---------------------------------------------------------------------
// Scan graph with precomputed shortest paths and candidates
// ---------------------------------------------------------------------
struct Scan {
  int n = 0;
  int k_max = 0;
  std::vector<std::string> ids;
  std::unordered_map<std::string, int> id2ix;
  std::vector<double> pos;        // n*3
  std::vector<uint8_t> included;  // n
  std::vector<uint8_t> adj;       // n*n traversable (unobstructed & incl)
  std::vector<float> dist;        // n*n geodesic
  std::vector<int32_t> next_hop;  // n*n
  // candidates (padded to k_max per node)
  std::vector<int32_t> cand_nbr;
  std::vector<int32_t> cand_point;
  std::vector<float> cand_norm_heading;  // absolute heading of target
  std::vector<float> cand_elev;          // absolute target elevation
  std::vector<float> cand_rel_dist;
  std::vector<int32_t> cand_n;
  std::vector<int32_t> feat_row;  // node -> feature-table row (from py)
};

void compute_shortest_paths(Scan& s) {
  const int n = s.n;
  s.dist.assign((size_t)n * n, std::numeric_limits<float>::infinity());
  s.next_hop.assign((size_t)n * n, -1);
  // adjacency lists with euclidean weights
  std::vector<std::vector<std::pair<int, double>>> nbrs(n);
  for (int u = 0; u < n; ++u) {
    for (int v = 0; v < n; ++v) {
      if (!s.adj[(size_t)u * n + v] || u == v) continue;
      double dx = s.pos[3 * u] - s.pos[3 * v];
      double dy = s.pos[3 * u + 1] - s.pos[3 * v + 1];
      double dz = s.pos[3 * u + 2] - s.pos[3 * v + 2];
      nbrs[u].emplace_back(v, std::sqrt(dx * dx + dy * dy + dz * dz));
    }
  }
  std::vector<double> d(n);
  std::vector<int> first(n);
  using QE = std::pair<double, int>;
  for (int src = 0; src < n; ++src) {
    std::fill(d.begin(), d.end(),
              std::numeric_limits<double>::infinity());
    std::fill(first.begin(), first.end(), -1);
    d[src] = 0.0;
    std::priority_queue<QE, std::vector<QE>, std::greater<QE>> pq;
    pq.emplace(0.0, src);
    while (!pq.empty()) {
      auto [du, u] = pq.top();
      pq.pop();
      if (du > d[u]) continue;
      for (auto [v, w] : nbrs[u]) {
        double nd = du + w;
        if (nd < d[v]) {
          d[v] = nd;
          first[v] = (u == src) ? v : first[u];
          pq.emplace(nd, v);
        }
      }
    }
    float* drow = &s.dist[(size_t)src * n];
    int32_t* hrow = &s.next_hop[(size_t)src * n];
    for (int v = 0; v < n; ++v) {
      drow[v] = (float)d[v];
      hrow[v] = first[v];
    }
    s.dist[(size_t)src * n + src] = 0.0f;
  }
}

// Closed-form 36-view candidate sweep; mirrors
// dasa_tpu_torch/sim/engine.py::compute_pano_candidates (itself conformance-
// tested against the reference make_candidate, env.py:240-315).
void compute_candidates(Scan& s, int k_max) {
  const int n = s.n;
  s.k_max = k_max;
  s.cand_nbr.assign((size_t)n * k_max, -1);
  s.cand_point.assign((size_t)n * k_max, 0);
  s.cand_norm_heading.assign((size_t)n * k_max, 0.f);
  s.cand_elev.assign((size_t)n * k_max, 0.f);
  s.cand_rel_dist.assign((size_t)n * k_max, 0.f);
  s.cand_n.assign(n, 0);
  double view_h[kViews], view_e[kViews];
  for (int v = 0; v < kViews; ++v) {
    view_h[v] = (v % kHeadings) * kHeadingInc;
    view_e[v] = (v / kHeadings - 1) * kElevationInc;
  }
  for (int u = 0; u < n; ++u) {
    int count = 0;
    for (int j = 0; j < n && count < k_max; ++j) {
      if (j == u || !s.adj[(size_t)u * n + j]) continue;
      double tx = s.pos[3 * j] - s.pos[3 * u];
      double ty = s.pos[3 * j + 1] - s.pos[3 * u + 1];
      double tz = s.pos[3 * j + 2] - s.pos[3 * u + 2];
      double xy = std::sqrt(tx * tx + ty * ty);
      double bearing = std::atan2(tx, ty);
      double elev_abs = std::atan2(tz, xy);
      double best = std::numeric_limits<double>::infinity();
      int best_v = 0;
      double best_rel_h = 0.0;
      for (int v = 0; v < kViews; ++v) {
        double rel_h = wrap_pi(bearing - view_h[v]);
        if (std::cos(rel_h) < kCosHalfHfov) continue;  // not visible
        double rel_e = elev_abs - view_e[v];
        double a = std::sqrt(rel_h * rel_h + rel_e * rel_e);
        if (a < best) {
          best = a;
          best_v = v;
          best_rel_h = rel_h;
        }
      }
      size_t o = (size_t)u * k_max + count;
      s.cand_nbr[o] = j;
      s.cand_point[o] = best_v;
      s.cand_norm_heading[o] = (float)(view_h[best_v] + best_rel_h);
      s.cand_elev[o] = (float)elev_abs;
      s.cand_rel_dist[o] =
          (float)std::sqrt(tx * tx + ty * ty + tz * tz);
      ++count;
    }
    s.cand_n[u] = count;
  }
}

struct Episode {
  int scan = -1;
  int node = 0;
  int view = 12;  // horizon, heading 0
  int goal = 0;
  int start = 0;
  int step = 0;
  float total_dist = 0.f;
};

struct Engine {
  std::vector<std::unique_ptr<Scan>> scans;
  std::vector<Episode> eps;
  int k_max = 16;
};

int heading_step_snap(double heading) {
  double h = std::fmod(heading, kTwoPi);
  if (h < 0) h += kTwoPi;
  int hs = (int)std::floor(h / kHeadingInc + 0.5);
  if (hs == kHeadings) hs = 0;
  return hs;
}

}  // namespace

extern "C" {

void* dasasim_create(int k_max) {
  auto* e = new Engine();
  e->k_max = k_max;
  return e;
}

void dasasim_destroy(void* h) { delete static_cast<Engine*>(h); }

// Load a connectivity JSON; returns the scan handle (or -1 on error).
int dasasim_load_scan(void* h, const char* path) {
  auto* e = static_cast<Engine*>(h);
  std::ifstream f(path);
  if (!f.good()) return -1;
  std::stringstream ss;
  ss << f.rdbuf();
  std::string text = ss.str();
  JsonParser parser(text);
  JsonValue root = parser.parse();
  if (root.kind != JsonValue::kArray) return -1;
  auto scan = std::make_unique<Scan>();
  int n = (int)root.arr.size();
  scan->n = n;
  scan->pos.resize((size_t)n * 3);
  scan->included.resize(n);
  scan->adj.assign((size_t)n * n, 0);
  for (int i = 0; i < n; ++i) {
    const JsonValue& item = root.arr[i];
    const JsonValue* id = item.find("image_id");
    const JsonValue* pose = item.find("pose");
    const JsonValue* inc = item.find("included");
    const JsonValue* un = item.find("unobstructed");
    if (!id || !pose || !inc || !un) return -1;
    scan->ids.push_back(id->str);
    scan->id2ix[id->str] = i;
    // translation at row-major flat indices 3, 7, 11
    scan->pos[3 * i] = pose->arr[3].num;
    scan->pos[3 * i + 1] = pose->arr[7].num;
    scan->pos[3 * i + 2] = pose->arr[11].num;
    scan->included[i] = inc->b ? 1 : 0;
    for (int j = 0; j < n && j < (int)un->arr.size(); ++j)
      scan->adj[(size_t)i * n + j] = un->arr[j].b ? 1 : 0;
  }
  // traversable = unobstructed & both included
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j)
      if (!scan->included[i] || !scan->included[j])
        scan->adj[(size_t)i * n + j] = 0;
  compute_shortest_paths(*scan);
  compute_candidates(*scan, e->k_max);
  scan->feat_row.assign(n, 0);
  e->scans.push_back(std::move(scan));
  return (int)e->scans.size() - 1;
}

int dasasim_num_nodes(void* h, int scan) {
  return static_cast<Engine*>(h)->scans[scan]->n;
}

int dasasim_node_index(void* h, int scan, const char* vid) {
  auto& s = *static_cast<Engine*>(h)->scans[scan];
  auto it = s.id2ix.find(vid);
  return it == s.id2ix.end() ? -1 : it->second;
}

const char* dasasim_node_id(void* h, int scan, int node) {
  return static_cast<Engine*>(h)->scans[scan]->ids[node].c_str();
}

void dasasim_set_feat_rows(void* h, int scan, const int32_t* rows) {
  auto& s = *static_cast<Engine*>(h)->scans[scan];
  std::memcpy(s.feat_row.data(), rows, sizeof(int32_t) * s.n);
}

float dasasim_distance(void* h, int scan, int a, int b) {
  auto& s = *static_cast<Engine*>(h)->scans[scan];
  return s.dist[(size_t)a * s.n + b];
}

int dasasim_next_hop(void* h, int scan, int a, int b) {
  auto& s = *static_cast<Engine*>(h)->scans[scan];
  return s.next_hop[(size_t)a * s.n + b];
}

// Path a..b inclusive into out (cap entries); returns length or -1.
int dasasim_shortest_path(void* h, int scan, int a, int b, int32_t* out,
                          int cap) {
  auto& s = *static_cast<Engine*>(h)->scans[scan];
  int len = 0;
  int cur = a;
  if (len < cap) out[len++] = cur;
  while (cur != b) {
    cur = s.next_hop[(size_t)cur * s.n + b];
    if (cur < 0 || len >= cap) return -1;
    out[len++] = cur;
  }
  return len;
}

void dasasim_candidates(void* h, int scan, int node, int32_t* nbr,
                        int32_t* point, float* norm_heading, float* elev,
                        float* rel_dist, int32_t* n_out) {
  auto& s = *static_cast<Engine*>(h)->scans[scan];
  size_t o = (size_t)node * s.k_max;
  std::memcpy(nbr, &s.cand_nbr[o], sizeof(int32_t) * s.k_max);
  std::memcpy(point, &s.cand_point[o], sizeof(int32_t) * s.k_max);
  std::memcpy(norm_heading, &s.cand_norm_heading[o],
              sizeof(float) * s.k_max);
  std::memcpy(elev, &s.cand_elev[o], sizeof(float) * s.k_max);
  std::memcpy(rel_dist, &s.cand_rel_dist[o], sizeof(float) * s.k_max);
  *n_out = s.cand_n[node];
}

// starts: the actual spawn nodes (may differ from path starts under
// random-start training); path0s: the annotated path[0] nodes used for
// back_teacher and progress normalization (reference env.py:352-358,
// 428-442).
void dasasim_reset(void* h, int batch, const int32_t* scans,
                   const int32_t* starts, const int32_t* path0s,
                   const int32_t* goals, const double* headings) {
  auto* e = static_cast<Engine*>(h);
  e->eps.resize(batch);
  for (int i = 0; i < batch; ++i) {
    Episode& ep = e->eps[i];
    ep.scan = scans[i];
    ep.node = starts[i];
    ep.start = path0s[i];
    ep.goal = goals[i];
    ep.step = 0;
    ep.view = heading_step_snap(headings[i]) + kHeadings;  // elevation 0
    auto& s = *e->scans[ep.scan];
    ep.total_dist = s.dist[(size_t)ep.start * s.n + ep.goal];
  }
}

// actions: candidate index per episode, -1/out-of-range = no-op (STOP)
void dasasim_step(void* h, int batch, const int32_t* actions) {
  auto* e = static_cast<Engine*>(h);
  for (int i = 0; i < batch; ++i) {
    Episode& ep = e->eps[i];
    auto& s = *e->scans[ep.scan];
    int a = actions[i];
    if (a < 0 || a >= s.cand_n[ep.node]) continue;
    size_t o = (size_t)ep.node * s.k_max + a;
    ep.node = s.cand_nbr[o];
    ep.view = s.cand_point[o];
    ep.step += 1;
  }
}

// Teleport episode i to an arbitrary node/view (search expansion:
// the reference re-news episodes mid-search, agent_dg.py:1135-1140).
void dasasim_teleport(void* h, int i, int node, int view) {
  auto* e = static_cast<Engine*>(h);
  e->eps[i].node = node;
  e->eps[i].view = view;
}

void dasasim_get_state(void* h, int batch, int32_t* scan, int32_t* node,
                       int32_t* view, int32_t* step) {
  auto* e = static_cast<Engine*>(h);
  for (int i = 0; i < batch; ++i) {
    scan[i] = e->eps[i].scan;
    node[i] = e->eps[i].node;
    view[i] = e->eps[i].view;
    step[i] = e->eps[i].step;
  }
}

// Fill the dense observation arrays for the whole batch in one call
// (replaces the per-item Python loop in R2REnv._get_obs).
void dasasim_fill_obs(void* h, int batch, int K, int32_t* feat_row,
                      int32_t* view_index, float* heading,
                      float* elevation, int32_t* cand_point_id,
                      int32_t* cand_nbr_ix, float* cand_heading,
                      float* cand_elevation, int32_t* cand_n,
                      int32_t* teacher, int32_t* back_teacher,
                      float* distance, float* progress) {
  auto* e = static_cast<Engine*>(h);
  for (int i = 0; i < batch; ++i) {
    Episode& ep = e->eps[i];
    auto& s = *e->scans[ep.scan];
    feat_row[i] = s.feat_row[ep.node];
    view_index[i] = ep.view;
    heading[i] = (float)((ep.view % kHeadings) * kHeadingInc);
    elevation[i] = (float)((ep.view / kHeadings - 1) * kElevationInc);
    int nc = std::min(s.cand_n[ep.node], K - 1);  // keep a STOP slot
    cand_n[i] = nc;
    double base_heading = (ep.view % kHeadings) * kHeadingInc;
    size_t o = (size_t)ep.node * s.k_max;
    for (int k = 0; k < K; ++k) {
      size_t oi = (size_t)i * K + k;
      if (k < nc) {
        cand_point_id[oi] = s.cand_point[o + k];
        cand_nbr_ix[oi] = s.cand_nbr[o + k];
        cand_heading[oi] =
            (float)(s.cand_norm_heading[o + k] - base_heading);
        cand_elevation[oi] = s.cand_elev[o + k];
      } else {
        cand_point_id[oi] = 0;
        cand_nbr_ix[oi] = -1;
        cand_heading[oi] = 0.f;
        cand_elevation[oi] = 0.f;
      }
    }
    // teacher: candidate slot of the next hop toward the goal; nc = STOP
    auto teach = [&](int target) -> int32_t {
      if (ep.node == target) return nc;
      int nh = s.next_hop[(size_t)ep.node * s.n + target];
      if (nh < 0) return nc;
      for (int k = 0; k < nc; ++k)
        if (s.cand_nbr[o + k] == nh) return k;
      return nc;
    };
    teacher[i] = teach(ep.goal);
    back_teacher[i] = teach(ep.start);
    float d = s.dist[(size_t)ep.node * s.n + ep.goal];
    distance[i] = d;
    progress[i] = 1.0f - d / (ep.total_dist + 1e-10f);
  }
}

}  // extern "C"
