// upmix_net_client — native network front end for the stream server.
//
// Raw interleaved float32 stereo -> ONE session on an upmix
// StreamServer (protocol v2; upmix/serve_stream.py) -> raw float32
// on stdout.  The embedded-host shell of the serving triangle: a
// Bela-class device (the reference's whole runtime,
// bela/upmix.cpp:516-553, is a single stream of
// hardware blocks exactly like this) or an ffmpeg pipe streams through
// this binary while the pooled GPU server does the DSP.  No DSP, no
// Python, no JAX in-process — the binary is the wire protocol plus the
// framing, composing exactly like upmix_cli but with the math on the
// server's pool:
//
//   ffmpeg -i in.flac -f f32le -ac 2 - \
//     | ./upmix_net_client --host 10.0.0.5 --port 9977 \
//     | ffmpeg -f f32le -ar 44100 -ac 2 -i - out.wav
//
// The server's output is warmup-aligned per session (output frame i
// corresponds to input frame i and the tail is drained), so
// len(stdout) == len(input) in frames and this is a drop-in pipe
// filter.  The final short block is zero-padded on the wire and the
// surplus output frames are trimmed here (stream_client's semantics).
//
// Resume (--in FILE --retries N): with a seekable input file the
// client rides the server's checkpoint/resume contract — on a
// mid-stream disconnect it reconnects with its protocol-v2 session
// token, resends from the server's acked input position (file seek),
// and discards the output frames the restored server regenerates
// (reply.out_frames is the checkpoint position; the client already
// wrote `emitted` frames and skips `emitted - out_frames`).  The
// stitched stdout is sample-exact vs an uninterrupted run (the
// server-side guarantee, serve_stream.py checkpoint docs).  stdin
// cannot rewind, so --retries requires --in.  --token-file persists
// the session token for operators.
//
// Build: make -C native net
//
// Wire protocol (little-endian; serve_stream.py:12-22):
//   hello:  "UPMX" u32 version(2) u32 mix(0 stereo_sum, 1 lcr)
//           + 16-byte resume token (zeros = new session)
//   reply:  "UPMR" u32 status u32 slot u32 hw u32 out_channels
//           + 16-byte session token + u64 in_frames u64 out_frames
//           + f64 sample_rate
//   then hw*2 float32 per input block, hw*out_channels per output.

#include <arpa/inet.h>
#include <csignal>
#include <netdb.h>
#include <sys/socket.h>
#include <unistd.h>

#include <atomic>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include "f32_pipe.h"

namespace {

constexpr size_t kTokenLen = 16;

size_t recv_exact(int fd, unsigned char* buf, size_t n) {
  size_t got = 0;
  while (got < n) {
    ssize_t r = ::recv(fd, buf + got, n - got, 0);
    if (r <= 0) break;
    got += (size_t)r;
  }
  return got;
}

bool send_all(int fd, const unsigned char* buf, size_t n) {
  size_t sent = 0;
  while (sent < n) {
    ssize_t r = ::send(fd, buf + sent, n - sent, MSG_NOSIGNAL);
    if (r <= 0) return false;
    sent += (size_t)r;
  }
  return true;
}

uint32_t le32(const unsigned char* p) {
  return (uint32_t)p[0] | ((uint32_t)p[1] << 8) | ((uint32_t)p[2] << 16) |
         ((uint32_t)p[3] << 24);
}

uint64_t le64(const unsigned char* p) {
  return (uint64_t)le32(p) | ((uint64_t)le32(p + 4) << 32);
}

void put32(unsigned char* p, uint32_t v) {
  p[0] = v & 0xff;
  p[1] = (v >> 8) & 0xff;
  p[2] = (v >> 16) & 0xff;
  p[3] = (v >> 24) & 0xff;
}

int usage(const char* argv0) {
  std::fprintf(
      stderr,
      "usage: %s --port <port> [--host 127.0.0.1]\n"
      "          [--mix stereo_sum|lcr] [--sr <rate>]\n"
      "          [--in FILE.f32] [--retries N] [--retry-delay SECS]\n"
      "          [--token-file PATH]\n"
      "raw float32 interleaved stereo: stdin (or --in) -> server -> "
      "stdout\n"
      "--sr validates the server's sample rate before sending; --retries\n"
      "reconnects with the session's resume token after a mid-stream\n"
      "disconnect (needs a seekable --in file)\n",
      argv0);
  return 2;
}

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

int connect_to(const std::string& host, const std::string& port) {
  struct addrinfo hints;
  std::memset(&hints, 0, sizeof(hints));
  hints.ai_family = AF_UNSPEC;
  hints.ai_socktype = SOCK_STREAM;
  struct addrinfo* res = nullptr;
  int rc = ::getaddrinfo(host.c_str(), port.c_str(), &hints, &res);
  if (rc != 0) {
    std::fprintf(stderr, "resolve %s:%s: %s\n", host.c_str(), port.c_str(),
                 gai_strerror(rc));
    // Resolve failures are retryable like connect failures: a rolling
    // restart can produce transient EAI_AGAIN/EAI_NONAME blips and the
    // retry loop must survive them just like a refused connect.
    return -1;
  }
  int fd = -1;
  for (struct addrinfo* ai = res; ai; ai = ai->ai_next) {
    fd = ::socket(ai->ai_family, ai->ai_socktype, ai->ai_protocol);
    if (fd < 0) continue;
    if (::connect(fd, ai->ai_addr, ai->ai_addrlen) == 0) break;
    ::close(fd);
    fd = -1;
  }
  ::freeaddrinfo(res);
  return fd;
}

struct Reply {
  uint32_t status = 0, hw = 0, out_ch = 0;
  unsigned char token[kTokenLen];
  uint64_t in_frames = 0, out_frames = 0;
  double sr = 0.0;
};

// -1 = transport failure (no/short reply), else reply parsed.
int handshake(int fd, uint32_t mix_code, const unsigned char* token,
              Reply* out) {
  unsigned char hello[12 + kTokenLen];
  std::memcpy(hello, "UPMX", 4);
  put32(hello + 4, 2);  // protocol v2
  put32(hello + 8, mix_code);
  std::memcpy(hello + 12, token, kTokenLen);
  if (!send_all(fd, hello, sizeof(hello))) return -1;
  unsigned char reply[20 + kTokenLen + 24];
  if (recv_exact(fd, reply, sizeof(reply)) != sizeof(reply) ||
      std::memcmp(reply, "UPMR", 4) != 0)
    return -1;
  out->status = le32(reply + 4);
  out->hw = le32(reply + 12);
  out->out_ch = le32(reply + 16);
  std::memcpy(out->token, reply + 20, kTokenLen);
  out->in_frames = le64(reply + 20 + kTokenLen);
  out->out_frames = le64(reply + 20 + kTokenLen + 8);
  uint64_t bits = le64(reply + 20 + kTokenLen + 16);
  std::memcpy(&out->sr, &bits, 8);
  return 0;
}

}  // namespace

int main(int argc, char** argv) {
  std::string host = "127.0.0.1";
  std::string port;
  std::string mix = "stereo_sum";
  std::string in_path;
  std::string token_path;
  double expect_sr = 0.0;
  long retries = 0;
  double retry_delay = 0.5;

  for (int i = 1; i < argc; ++i) {
    std::string a = argv[i];
    auto next = [&](const char* what) -> const char* {
      if (i + 1 >= argc) {
        std::fprintf(stderr, "missing value for %s\n", what);
        std::exit(2);
      }
      return argv[++i];
    };
    if (a == "--host") host = next("--host");
    else if (a == "--port") port = next("--port");
    else if (a == "--mix") mix = next("--mix");
    else if (a == "--sr") expect_sr = parse_num("--sr", next("--sr"));
    else if (a == "--in") in_path = next("--in");
    else if (a == "--retries") retries = parse_int("--retries", next("--retries"));
    else if (a == "--retry-delay")
      retry_delay = parse_num("--retry-delay", next("--retry-delay"));
    else if (a == "--token-file") token_path = next("--token-file");
    else return usage(argv[0]);
  }
  if (port.empty()) return usage(argv[0]);
  if (retries > 0 && in_path.empty()) {
    std::fprintf(stderr,
                 "--retries needs a seekable --in file (stdin cannot be "
                 "rewound to the server's resume position)\n");
    return 2;
  }
  uint32_t mix_code;
  if (mix == "stereo_sum") mix_code = 0;
  else if (mix == "lcr") mix_code = 1;
  else return usage(argv[0]);

  // fwrite to a closed stdout pipe must fail with EPIPE (handled as a
  // graceful "downstream closed" drain) — not kill the process via the
  // default SIGPIPE disposition.  Socket sends already use MSG_NOSIGNAL.
  std::signal(SIGPIPE, SIG_IGN);

  FILE* in = stdin;
  long long total = -1;  // frames; known upfront for --in, at EOF for stdin
  if (!in_path.empty()) {
    in = std::fopen(in_path.c_str(), "rb");
    if (!in) {
      std::fprintf(stderr, "cannot open %s\n", in_path.c_str());
      return 1;
    }
    long end = -1;
    if (std::fseek(in, 0, SEEK_END) == 0) end = std::ftell(in);
    if (end < 0 || std::fseek(in, 0, SEEK_SET) != 0) {
      // A FIFO/pipe fails the seek: without a real size the output cap
      // would silently discard everything — refuse instead.
      std::fprintf(stderr,
                   "--in needs a regular (seekable) file, not a pipe; "
                   "stream pipes via stdin instead\n");
      return 2;
    }
    total = end / 8;  // whole stereo f32 frames
  }

  unsigned char token[kTokenLen];
  std::memset(token, 0, kTokenLen);  // zeros = new session
  long long emitted = 0;  // output frames written to stdout, across attempts
  bool stdout_open = true;

  for (long attempt = 0; attempt <= retries; ++attempt) {
    if (attempt > 0) {
      std::fprintf(stderr, "reconnecting (attempt %ld/%ld)...\n", attempt,
                   retries);
      ::usleep((useconds_t)(retry_delay * 1e6));
    }
    int fd = connect_to(host, port);
    if (fd < 0) {
      if (attempt < retries) continue;
      std::fprintf(stderr, "connect %s:%s failed\n", host.c_str(),
                   port.c_str());
      return 1;
    }

    Reply rep;
    if (handshake(fd, mix_code, token, &rep) != 0) {
      ::close(fd);
      if (attempt < retries) continue;
      std::fprintf(stderr, "bad server reply\n");
      return 1;
    }
    if (rep.status == 1) {
      ::close(fd);
      std::fprintf(stderr, "server pool is full\n");
      return 1;
    }
    if (rep.status == 3) {
      ::close(fd);
      // Retryable while attempts remain: during a rolling restart the
      // client can hit a STOPPING server (which refuses resumes with
      // status 3) or one that has not loaded the checkpoint yet.
      if (attempt < retries) continue;
      std::fprintf(stderr,
                   "server does not know this session's resume token "
                   "(restarted without the checkpoint?)\n");
      return 1;
    }
    if (rep.status != 0) {
      ::close(fd);
      std::fprintf(stderr, "server rejected hello (status %u)\n", rep.status);
      return 1;
    }
    if (expect_sr > 0.0 &&
        (rep.sr > expect_sr + 1e-6 || rep.sr < expect_sr - 1e-6)) {
      ::close(fd);
      std::fprintf(stderr,
                   "server runs at %g Hz but --sr says %g Hz — resample or "
                   "use a matching server\n",
                   rep.sr, expect_sr);
      return 1;
    }
    std::memcpy(token, rep.token, kTokenLen);
    if (!token_path.empty()) {
      FILE* tf = std::fopen(token_path.c_str(), "wb");
      if (tf) {
        std::fwrite(token, 1, kTokenLen, tf);
        std::fclose(tf);
      }
    }

    // Resume bookkeeping: resend input from the server's acked position
    // and discard the output frames the restored server regenerates.
    long long discard = 0;
    long long start = 0;
    if (attempt > 0) {
      // The server acks the zero-PADDED final block when it enqueues
      // it, so a checkpoint taken with that block still queued
      // legitimately records in_frames = ceil(total/hw)*hw > total —
      // everything (tail included) is already server-side; resend
      // nothing.  Anything beyond the padded length is a real
      // mismatch (wrong file for this token).
      long long hw64 = (long long)rep.hw;
      long long padded = (total + hw64 - 1) / hw64 * hw64;
      if ((long long)rep.in_frames > padded) {
        std::fprintf(stderr, "server acked more input than the file has\n");
        ::close(fd);
        return 1;
      }
      start = (long long)rep.in_frames;
      if (start > total) start = total;  // padded tail already acked
      discard = emitted - (long long)rep.out_frames;
      if (discard < 0) {
        // Frames the server counted delivered before its checkpoint
        // never reached us and will not be regenerated — the stream
        // has a hole and no clean continuation exists.
        std::fprintf(stderr,
                     "unresumable: %lld output frames were lost in flight "
                     "before the server's checkpoint\n",
                     -discard);
        ::close(fd);
        return 1;
      }
      std::fseek(in, (long)(start * 8), SEEK_SET);
    }

    const uint32_t hw = rep.hw;
    // total_in is published BEFORE the final (padded or empty) block is
    // sent, so the receive side can cap its writes before any
    // pad-derived output frame can possibly arrive.
    std::atomic<long long> total_in{total};
    long long base = start;
    std::thread sender([&, fd, hw, base] {
      std::vector<unsigned char> raw((size_t)hw * 2 * 4);
      long long sum = base;
      for (;;) {
        size_t got = upmix_pipe::read_exact(in, raw.data(), raw.size());
        size_t frames = got / 8;  // whole stereo f32 frames
        if (frames < hw) {
          total_in.store(sum + (long long)frames);
          if (frames > 0) {
            std::memset(raw.data() + frames * 8, 0, raw.size() - frames * 8);
            send_all(fd, raw.data(), raw.size());
          }
          break;
        }
        if (!send_all(fd, raw.data(), raw.size())) break;  // server gone
        sum += (long long)hw;
      }
      ::shutdown(fd, SHUT_WR);
    });

    const size_t frame_bytes = (size_t)rep.out_ch * 4;
    std::vector<unsigned char> buf(1 << 16);
    std::vector<unsigned char> pending;
    for (;;) {
      ssize_t r = ::recv(fd, buf.data(), buf.size(), 0);
      if (r <= 0) break;
      if (!stdout_open) continue;  // drain so the sender finishes
      pending.insert(pending.end(), buf.data(), buf.data() + r);
      long long have = (long long)(pending.size() / frame_bytes);
      if (discard > 0) {
        long long k = have < discard ? have : discard;
        pending.erase(pending.begin(), pending.begin() + k * frame_bytes);
        discard -= k;
        have -= k;
      }
      long long limit = total_in.load();
      long long n = have;
      if (limit >= 0 && n > limit - emitted) n = limit - emitted;
      if (n > 0) {
        if (std::fwrite(pending.data(), frame_bytes, (size_t)n, stdout) !=
            (size_t)n) {
          stdout_open = false;  // downstream closed (SIGPIPE semantics)
        }
        emitted += n;
        pending.erase(pending.begin(), pending.begin() + n * frame_bytes);
      }
    }
    sender.join();
    ::close(fd);

    long long limit = total_in.load();
    if (!stdout_open || (limit >= 0 && emitted >= limit)) {
      std::fflush(stdout);
      return 0;  // complete (or downstream closed — nothing left to do)
    }
    if (attempt >= retries) {
      std::fflush(stdout);
      if (limit >= 0)
        std::fprintf(stderr, "short stream: got %lld of %lld frames\n",
                     emitted, limit);
      else
        std::fprintf(stderr, "server closed mid-stream after %lld frames\n",
                     emitted);
      return 1;
    }
    // else: mid-stream disconnect — loop reconnects with the token.
  }
  return 1;  // unreachable
}
