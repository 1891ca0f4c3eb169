// Runs K3 (csrc/int8_matmul_t.cu) on the CPU through common.cuh's emulation.
//
//   k3_harness M K N ctas stages eager schedule in out
//
// `in` holds x (bf16 [M, K]), then w8 (int8 [N, K]), then s (bf16 [N]);
// `out` receives the f32 [M, N] output. `ctas` is the number of persistent
// CTAs and `stages` the ring's depth (0: the launcher's own choice); `eager` 1 lands every cp.async copy
// at once, 0 at its wait_group; `schedule` is an emu::Schedule. Only x and
// the N rows of w8 are registered as device memory, so a copy from past
// them aborts. The output buffer has 64 guard rows after its M rows, which
// must keep their fill. The kernel runs twice, its CTAs first in launch
// order, then in reverse. Prints the launcher's return code, the ldmatrix
// bank conflicts, whether the guard rows are untouched and whether the two
// outputs are equal bit for bit.
#include "int8_matmul_t.cu"

#include <fstream>
#include <iterator>

int main(int argc, char** argv) {
    if (argc != 10) {
        fprintf(stderr, "usage: k3_harness M K N ctas stages eager schedule in out\n");
        return 2;
    }
    const int M = atoi(argv[1]), K = atoi(argv[2]), N = atoi(argv[3]), ctas = atoi(argv[4]);
    const int stages = atoi(argv[5]);
    emu::eager_copies = atoi(argv[6]) != 0;
    emu::schedule = static_cast<emu::Schedule>(atoi(argv[7]));
    std::ifstream in(argv[8], std::ios::binary);
    const std::vector<char> bytes((std::istreambuf_iterator<char>(in)), {});
    const size_t x_bytes = size_t(M) * K * 2, w_bytes = size_t(N) * K;
    if (bytes.size() != x_bytes + w_bytes + size_t(N) * 2) {
        fprintf(stderr, "input size\n");
        return 2;
    }
    // separate 16-byte aligned buffers, x and w8 registered as device memory
    std::vector<uint4> xb((x_bytes + 15) / 16), wb((w_bytes + 15) / 16), sb((N * 2 + 15) / 16);
    std::memcpy(xb.data(), bytes.data(), x_bytes);
    std::memcpy(wb.data(), bytes.data() + x_bytes, w_bytes);
    std::memcpy(sb.data(), bytes.data() + x_bytes + w_bytes, N * 2);
    emu::add_global(xb.data(), x_bytes);
    emu::add_global(wb.data(), w_bytes);
    const size_t n_out = size_t(M) * N, n_guard = size_t(64) * N;
    constexpr uint32_t kFill = 0x7fbadbadu;  // a NaN no store of the kernel gives
    std::vector<uint32_t> out[2];
    int rc = 0;
    bool guard_ok = true;
    for (int run = 0; run < 2; ++run) {
        emu::reverse_ctas = run == 1;
        out[run].assign(n_out + n_guard, kFill);
        rc |= launch(xb.data(), wb.data(), sb.data(), out[run].data(), M, K, N, ctas, stages,
                     nullptr);
        for (size_t i = n_out; i < n_out + n_guard; ++i) guard_ok = guard_ok && out[run][i] == kFill;
        out[run].resize(n_out);
    }
    std::ofstream(argv[9], std::ios::binary)
        .write(reinterpret_cast<const char*>(out[0].data()), n_out * 4);
    printf("rc=%d bank_conflicts=%ld ldmatrix=%ld guard=%d identical=%d\n", rc,
           emu::bank_conflicts, emu::ldmatrix_calls, int(guard_ok), int(out[0] == out[1]));
    return rc;
}
