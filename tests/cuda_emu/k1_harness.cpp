// Runs K1 (csrc/fused_attention.cu, launch rewritten for emu_launch) on the
// CPU through common.cuh's emulation.
//
//   k1_harness B T H s_b s_t s_h q_off k_off v_off eager schedule in out
//
// `in` holds the bf16 buffer that q, k and v lie in (element offsets and
// [B, T, H] strides as given, the same for all three); `out` receives the
// contiguous [B, T, H, 64] bf16 output. `eager` 1 lands every cp.async copy
// at once, 0 at its wait_group; `schedule` is an emu::Schedule. Prints the
// launcher's return code and the ldmatrix bank conflicts.
#include "fused_attention.cu"

#include <fstream>
#include <iterator>

int main(int argc, char** argv) {
    if (argc != 14) {
        fprintf(stderr,
                "usage: k1_harness B T H s_b s_t s_h q_off k_off v_off eager schedule in out\n");
        return 2;
    }
    const int B = atoi(argv[1]), T = atoi(argv[2]), H = atoi(argv[3]);
    const long long sb = atoll(argv[4]), st = atoll(argv[5]), sh = atoll(argv[6]);
    const long long qo = atoll(argv[7]), ko = atoll(argv[8]), vo = atoll(argv[9]);
    emu::eager_copies = atoi(argv[10]) != 0;
    emu::schedule = static_cast<emu::Schedule>(atoi(argv[11]));
    std::ifstream in(argv[12], std::ios::binary);
    const std::vector<char> bytes((std::istreambuf_iterator<char>(in)), {});
    std::vector<uint16_t> buf(bytes.size() / 2);
    std::memcpy(buf.data(), bytes.data(), bytes.size());
    emu::add_global(buf.data(), buf.size() * 2);
    std::vector<uint16_t> out(static_cast<size_t>(B) * T * H * 64, 0xffff);
    const int rc = wl_fused_attention(buf.data() + qo, buf.data() + ko, buf.data() + vo, out.data(),
                                      B, T, H, sb, st, sh, sb, st, sh, sb, st, sh, 0.125f, nullptr);
    std::ofstream(argv[13], std::ios::binary)
        .write(reinterpret_cast<const char*>(out.data()), out.size() * 2);
    printf("rc=%d bank_conflicts=%ld ldmatrix=%ld\n", rc, emu::bank_conflicts,
           emu::ldmatrix_calls);
    return rc;
}
