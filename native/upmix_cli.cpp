// upmix_cli — standalone native pipe filter (no Python, no accelerator).
//
// The deployment artifact for hosts that need the upmixer as a plain
// binary: raw interleaved float32 stereo on stdin -> processed float32
// on stdout, identical semantics to the Python CLI's
// `upmix - --pipe --engine native` (upmix/app.py::run_pipe):
// latency-aligned by default (output frame i corresponds to input frame
// i; len(out) == len(in)), --raw for the live-callback stream.
//
//   ffmpeg -i in.flac -f f32le -ac 2 - \
//     | ./upmix_cli --sr 44100 \
//     | ffmpeg -f f32le -ar 44100 -ac 2 -i - out.wav
//
// Build: make -C native cli

#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include "f32_pipe.h"

extern "C" {
void* upmix_create(double sr, int hw_block, const double* edges, int n_edges,
                   int xover_mode, int synthesis, int rounding,
                   double threshold_multi, double xo_fraction, int window,
                   int n_threads, int precision);
void upmix_destroy(void* h);
int upmix_latency_blocks(void* h);
int upmix_process_block(void* h, const float* inL, const float* inR,
                        float* outC, float* outLs, float* outRs);
}

namespace {

using upmix_pipe::read_exact;

int usage(const char* argv0) {
  std::fprintf(
      stderr,
      "usage: %s --sr <rate> [--hw 2048] [--edges 0,500,2000,8000]\n"
      "          [--mix stereo_sum|lcr] [--raw] [--threads 1]\n"
      "          [--xover raised_cosine|hard_zero] [--window bh|sqrt_hann|"
      "hann|blackman|hamming|rect]\n"
      "          [--synthesis analysis|wola] [--rounding cpp|python]\n"
      "          [--precision double|float]\n"
      "raw float32 interleaved stereo: stdin -> stdout\n",
      argv0);
  return 2;
}

// Strict numeric parsing: atof/atoi silently return 0 on garbage, which
// would turn "--edges foo" into an edge at 0 Hz; reject instead, matching
// the enum flags' strictness.
double parse_num(const char* what, const char* s) {
  char* end = nullptr;
  double v = std::strtod(s, &end);
  if (end == s || *end != '\0') {
    std::fprintf(stderr, "bad numeric value for %s: %s\n", what, s);
    std::exit(2);
  }
  return v;
}

long parse_int(const char* what, const char* s) {
  char* end = nullptr;
  long v = std::strtol(s, &end, 10);
  if (end == s || *end != '\0') {
    std::fprintf(stderr, "bad integer value for %s: %s\n", what, s);
    std::exit(2);
  }
  return v;
}

}  // namespace

int main(int argc, char** argv) {
  double sr = 0.0;
  int hw = 2048, n_threads = 1;
  bool align = true;
  std::string mix = "stereo_sum";
  std::vector<double> edges = {0.0, 500.0, 2000.0, 8000.0};
  int xover = 0, synthesis = 1, rounding = 1, window = 0;  // pipe defaults
  int precision = 0;  // double = parity mode; float = fast mode

  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    auto next = [&](const char* what) -> const char* {
      if (i + 1 >= argc) {
        std::fprintf(stderr, "missing value for %s\n", what);
        std::exit(2);
      }
      return argv[++i];
    };
    if (a == "--sr") sr = parse_num("--sr", next("--sr"));
    else if (a == "--hw") hw = (int)parse_int("--hw", next("--hw"));
    else if (a == "--threads") n_threads = (int)parse_int("--threads", next("--threads"));
    else if (a == "--raw") align = false;
    else if (a == "--mix") mix = next("--mix");
    else if (a == "--edges") {
      edges.clear();
      std::string s = next("--edges");
      size_t pos = 0;
      while (pos < s.size()) {
        size_t c = s.find(',', pos);
        if (c == std::string::npos) c = s.size();
        edges.push_back(parse_num("--edges", s.substr(pos, c - pos).c_str()));
        pos = c + 1;
      }
    } else if (a == "--xover") {
      std::string v = next("--xover");
      if (v == "hard_zero") xover = 1;
      else if (v == "raised_cosine") xover = 0;
      else { std::fprintf(stderr, "unknown --xover %s\n", v.c_str()); return 2; }
    } else if (a == "--synthesis") {
      std::string v = next("--synthesis");
      if (v == "wola") synthesis = 0;
      else if (v == "analysis") synthesis = 1;
      else { std::fprintf(stderr, "unknown --synthesis %s\n", v.c_str()); return 2; }
    } else if (a == "--rounding") {
      std::string v = next("--rounding");
      if (v == "python") rounding = 0;
      else if (v == "cpp") rounding = 1;
      else { std::fprintf(stderr, "unknown --rounding %s\n", v.c_str()); return 2; }
    } else if (a == "--precision") {
      std::string v = next("--precision");
      if (v == "double") precision = 0;
      else if (v == "float") precision = 1;
      else { std::fprintf(stderr, "unknown --precision %s\n", v.c_str()); return 2; }
    } else if (a == "--window") {
      std::string w = next("--window");
      if (w == "bh" || w == "blackman_harris") window = 0;
      else if (w == "sqrt_hann") window = 1;
      else if (w == "hann") window = 2;
      else if (w == "blackman") window = 3;
      else if (w == "hamming") window = 4;
      else if (w == "rect") window = 5;
      else { std::fprintf(stderr, "unknown --window %s\n", w.c_str()); return 2; }
    } else {
      return usage(argv[0]);
    }
  }
  if (sr <= 0.0 || hw < 4) return usage(argv[0]);
  if (mix != "stereo_sum" && mix != "lcr") return usage(argv[0]);

  void* h = upmix_create(sr, hw, edges.data(), (int)edges.size(), xover,
                         synthesis, rounding, 32.0, 0.25, window, n_threads,
                         precision);
  if (!h) {
    std::fprintf(stderr, "upmix_create failed (bad sr/hw/edges)\n");
    return 1;
  }
  int warmup = upmix_latency_blocks(h);
  long long to_skip = align ? (long long)(warmup - 1) * hw : 0;
  long long emitted = 0, total_in = 0;
  int out_ch = mix == "lcr" ? 3 : 2;

  std::vector<unsigned char> raw((size_t)hw * 2 * 4);
  std::vector<float> inL(hw), inR(hw), c(hw), ls(hw), rs(hw);
  std::vector<float> out((size_t)hw * out_ch);

  // Emit one processed block, honoring skip/limit (run_pipe semantics).
  auto write_block = [&](long long limit) {
    long long n = hw;
    long long off = 0;
    if (to_skip) {
      long long k = to_skip < n ? to_skip : n;
      off += k;
      n -= k;
      to_skip -= k;
    }
    if (limit >= 0 && n > limit - emitted) n = limit - emitted;
    if (n <= 0) return;
    for (long long i = 0; i < n; ++i) {
      long long s = off + i;
      if (out_ch == 2) {
        out[i * 2] = ls[s] + 0.5f * c[s];
        out[i * 2 + 1] = rs[s] + 0.5f * c[s];
      } else {
        out[i * 3] = c[s];
        out[i * 3 + 1] = ls[s];
        out[i * 3 + 2] = rs[s];
      }
    }
    if (std::fwrite(out.data(), 4, (size_t)(n * out_ch), stdout) !=
        (size_t)(n * out_ch)) {
      std::exit(0);  // downstream closed (SIGPIPE semantics)
    }
    emitted += n;
  };

  for (;;) {
    size_t got = read_exact(stdin, raw.data(), raw.size());
    if (got == 0) break;
    int n = (int)(got / 8);  // whole stereo f32 frames
    const float* f = reinterpret_cast<const float*>(raw.data());
    for (int i = 0; i < n; ++i) {
      inL[i] = f[i * 2];
      inR[i] = f[i * 2 + 1];
    }
    for (int i = n; i < hw; ++i) inL[i] = inR[i] = 0.0f;
    total_in += n;
    upmix_process_block(h, inL.data(), inR.data(), c.data(), ls.data(),
                        rs.data());
    // Only the final (partial) block can carry output past the input
    // length; cap it there (exactly run_pipe's limit rule).
    write_block(n < hw ? total_in : -1);
    if (n < hw) break;
  }
  if (align) {
    std::fill(inL.begin(), inL.end(), 0.0f);
    std::fill(inR.begin(), inR.end(), 0.0f);
    while (emitted < total_in) {
      upmix_process_block(h, inL.data(), inR.data(), c.data(), ls.data(),
                          rs.data());
      write_block(total_in);
    }
  }
  std::fflush(stdout);
  upmix_destroy(h);
  return 0;
}
