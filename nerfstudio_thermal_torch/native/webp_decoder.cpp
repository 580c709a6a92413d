// WebP decoder that computes what Pillow's np.asarray(Image.open(path))
// gives for a WebP file (Pillow decodes through libwebp's animation
// decoder, WebPAnimDecoder, in MODE_RGBA), byte for byte:
//   - the RIFF container: a simple VP8 or VP8L image, or VP8X with an ALPH
//     chunk, or an animation's first frame (ANMF), drawn at its offset on a
//     transparent black canvas as the animation decoder draws a key frame;
//   - VP8L (RFC 9649): prefix codes (simple and normal, the code-length
//     code), the colour cache, meta prefix codes, LZ77 with the 120-entry
//     distance map, and the predictor (14 modes), cross-colour,
//     subtract-green and colour-indexing (with pixel bundling) transforms;
//   - VP8 key frames (RFC 6386, as libwebp's decoder): the boolean decoder,
//     segments, the coefficient probabilities and their updates, intra
//     prediction (16x16, 4x4 with its ten modes, chroma; libwebp's 127 /
//     129 borders), dequantization, the inverse WHT and DCT, the simple and
//     normal loop filters with sharpness, deltas and per-segment levels;
//   - the YUV 4:2:0 -> RGB conversion of libwebp's default output: fancy
//     (bilinear 9-3-3-1) upsampling of the chroma and the 14-bit
//     fixed-point conversion of dsp/yuv.h;
//   - ALPH: raw or VP8L-compressed alpha, with the horizontal, vertical
//     and gradient unfilters.
// The mode follows Pillow: 4 channels (RGBA, straight alpha) when the file
// says it has alpha (the VP8X flag, or the VP8L header's bit), else 3.
//
// C interface (loaded with ctypes by data/webp.py):
//   int webp_decoder_abi_version();
//   int webp_decode(const uint8_t* data, size_t size, uint8_t* out, size_t out_size, int* dims,
//                   char* err, int err_size);
// dims receives {height, width, channels}; with out == nullptr only the
// headers are read. Returns 0 on success, 1 for an unsupported feature,
// 2 for a malformed file or a too-small buffer.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

struct Error {
  int code;
  std::string msg;
};

[[noreturn]] void fail(int code, const std::string& msg) { throw Error{code, msg}; }

// libwebp's tables (RFC 6386 / RFC 9649 constants), flattened
const uint8_t kBModesProba[900] = {
    231, 120, 48, 89, 115, 113, 120, 152, 112, 152, 179, 64, 126, 170, 118, 46, 70, 95,
    175, 69, 143, 80, 85, 82, 72, 155, 103, 56, 58, 10, 171, 218, 189, 17, 13, 152,
    114, 26, 17, 163, 44, 195, 21, 10, 173, 121, 24, 80, 195, 26, 62, 44, 64, 85,
    144, 71, 10, 38, 171, 213, 144, 34, 26, 170, 46, 55, 19, 136, 160, 33, 206, 71,
    63, 20, 8, 114, 114, 208, 12, 9, 226, 81, 40, 11, 96, 182, 84, 29, 16, 36,
    134, 183, 89, 137, 98, 101, 106, 165, 148, 72, 187, 100, 130, 157, 111, 32, 75, 80,
    66, 102, 167, 99, 74, 62, 40, 234, 128, 41, 53, 9, 178, 241, 141, 26, 8, 107,
    74, 43, 26, 146, 73, 166, 49, 23, 157, 65, 38, 105, 160, 51, 52, 31, 115, 128,
    104, 79, 12, 27, 217, 255, 87, 17, 7, 87, 68, 71, 44, 114, 51, 15, 186, 23,
    47, 41, 14, 110, 182, 183, 21, 17, 194, 66, 45, 25, 102, 197, 189, 23, 18, 22,
    88, 88, 147, 150, 42, 46, 45, 196, 205, 43, 97, 183, 117, 85, 38, 35, 179, 61,
    39, 53, 200, 87, 26, 21, 43, 232, 171, 56, 34, 51, 104, 114, 102, 29, 93, 77,
    39, 28, 85, 171, 58, 165, 90, 98, 64, 34, 22, 116, 206, 23, 34, 43, 166, 73,
    107, 54, 32, 26, 51, 1, 81, 43, 31, 68, 25, 106, 22, 64, 171, 36, 225, 114,
    34, 19, 21, 102, 132, 188, 16, 76, 124, 62, 18, 78, 95, 85, 57, 50, 48, 51,
    193, 101, 35, 159, 215, 111, 89, 46, 111, 60, 148, 31, 172, 219, 228, 21, 18, 111,
    112, 113, 77, 85, 179, 255, 38, 120, 114, 40, 42, 1, 196, 245, 209, 10, 25, 109,
    88, 43, 29, 140, 166, 213, 37, 43, 154, 61, 63, 30, 155, 67, 45, 68, 1, 209,
    100, 80, 8, 43, 154, 1, 51, 26, 71, 142, 78, 78, 16, 255, 128, 34, 197, 171,
    41, 40, 5, 102, 211, 183, 4, 1, 221, 51, 50, 17, 168, 209, 192, 23, 25, 82,
    138, 31, 36, 171, 27, 166, 38, 44, 229, 67, 87, 58, 169, 82, 115, 26, 59, 179,
    63, 59, 90, 180, 59, 166, 93, 73, 154, 40, 40, 21, 116, 143, 209, 34, 39, 175,
    47, 15, 16, 183, 34, 223, 49, 45, 183, 46, 17, 33, 183, 6, 98, 15, 32, 183,
    57, 46, 22, 24, 128, 1, 54, 17, 37, 65, 32, 73, 115, 28, 128, 23, 128, 205,
    40, 3, 9, 115, 51, 192, 18, 6, 223, 87, 37, 9, 115, 59, 77, 64, 21, 47,
    104, 55, 44, 218, 9, 54, 53, 130, 226, 64, 90, 70, 205, 40, 41, 23, 26, 57,
    54, 57, 112, 184, 5, 41, 38, 166, 213, 30, 34, 26, 133, 152, 116, 10, 32, 134,
    39, 19, 53, 221, 26, 114, 32, 73, 255, 31, 9, 65, 234, 2, 15, 1, 118, 73,
    75, 32, 12, 51, 192, 255, 160, 43, 51, 88, 31, 35, 67, 102, 85, 55, 186, 85,
    56, 21, 23, 111, 59, 205, 45, 37, 192, 55, 38, 70, 124, 73, 102, 1, 34, 98,
    125, 98, 42, 88, 104, 85, 117, 175, 82, 95, 84, 53, 89, 128, 100, 113, 101, 45,
    75, 79, 123, 47, 51, 128, 81, 171, 1, 57, 17, 5, 71, 102, 57, 53, 41, 49,
    38, 33, 13, 121, 57, 73, 26, 1, 85, 41, 10, 67, 138, 77, 110, 90, 47, 114,
    115, 21, 2, 10, 102, 255, 166, 23, 6, 101, 29, 16, 10, 85, 128, 101, 196, 26,
    57, 18, 10, 102, 102, 213, 34, 20, 43, 117, 20, 15, 36, 163, 128, 68, 1, 26,
    102, 61, 71, 37, 34, 53, 31, 243, 192, 69, 60, 71, 38, 73, 119, 28, 222, 37,
    68, 45, 128, 34, 1, 47, 11, 245, 171, 62, 17, 19, 70, 146, 85, 55, 62, 70,
    37, 43, 37, 154, 100, 163, 85, 160, 1, 63, 9, 92, 136, 28, 64, 32, 201, 85,
    75, 15, 9, 9, 64, 255, 184, 119, 16, 86, 6, 28, 5, 64, 255, 25, 248, 1,
    56, 8, 17, 132, 137, 255, 55, 116, 128, 58, 15, 20, 82, 135, 57, 26, 121, 40,
    164, 50, 31, 137, 154, 133, 25, 35, 218, 51, 103, 44, 131, 131, 123, 31, 6, 158,
    86, 40, 64, 135, 148, 224, 45, 183, 128, 22, 26, 17, 131, 240, 154, 14, 1, 209,
    45, 16, 21, 91, 64, 222, 7, 1, 197, 56, 21, 39, 155, 60, 138, 23, 102, 213,
    83, 12, 13, 54, 192, 255, 68, 47, 28, 85, 26, 85, 85, 128, 128, 32, 146, 171,
    18, 11, 7, 63, 144, 171, 4, 4, 246, 35, 27, 10, 146, 174, 171, 12, 26, 128,
    190, 80, 35, 99, 180, 80, 126, 54, 45, 85, 126, 47, 87, 176, 51, 41, 20, 32,
    101, 75, 128, 139, 118, 146, 116, 128, 85, 56, 41, 15, 176, 236, 85, 37, 9, 62,
    71, 30, 17, 119, 118, 255, 17, 18, 138, 101, 38, 60, 138, 55, 70, 43, 26, 142,
    146, 36, 19, 30, 171, 255, 97, 27, 20, 138, 45, 61, 62, 219, 1, 81, 188, 64,
    32, 41, 20, 117, 151, 142, 20, 21, 163, 112, 19, 12, 61, 195, 128, 48, 4, 24};
const uint8_t kCoeffsProba0[1056] = {
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 253, 136, 254, 255, 228, 219, 128, 128, 128, 128, 128,
    189, 129, 242, 255, 227, 213, 255, 219, 128, 128, 128, 106, 126, 227, 252, 214, 209, 255, 255, 128, 128, 128,
    1, 98, 248, 255, 236, 226, 255, 255, 128, 128, 128, 181, 133, 238, 254, 221, 234, 255, 154, 128, 128, 128,
    78, 134, 202, 247, 198, 180, 255, 219, 128, 128, 128, 1, 185, 249, 255, 243, 255, 128, 128, 128, 128, 128,
    184, 150, 247, 255, 236, 224, 128, 128, 128, 128, 128, 77, 110, 216, 255, 236, 230, 128, 128, 128, 128, 128,
    1, 101, 251, 255, 241, 255, 128, 128, 128, 128, 128, 170, 139, 241, 252, 236, 209, 255, 255, 128, 128, 128,
    37, 116, 196, 243, 228, 255, 255, 255, 128, 128, 128, 1, 204, 254, 255, 245, 255, 128, 128, 128, 128, 128,
    207, 160, 250, 255, 238, 128, 128, 128, 128, 128, 128, 102, 103, 231, 255, 211, 171, 128, 128, 128, 128, 128,
    1, 152, 252, 255, 240, 255, 128, 128, 128, 128, 128, 177, 135, 243, 255, 234, 225, 128, 128, 128, 128, 128,
    80, 129, 211, 255, 194, 224, 128, 128, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    246, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    198, 35, 237, 223, 193, 187, 162, 160, 145, 155, 62, 131, 45, 198, 221, 172, 176, 220, 157, 252, 221, 1,
    68, 47, 146, 208, 149, 167, 221, 162, 255, 223, 128, 1, 149, 241, 255, 221, 224, 255, 255, 128, 128, 128,
    184, 141, 234, 253, 222, 220, 255, 199, 128, 128, 128, 81, 99, 181, 242, 176, 190, 249, 202, 255, 255, 128,
    1, 129, 232, 253, 214, 197, 242, 196, 255, 255, 128, 99, 121, 210, 250, 201, 198, 255, 202, 128, 128, 128,
    23, 91, 163, 242, 170, 187, 247, 210, 255, 255, 128, 1, 200, 246, 255, 234, 255, 128, 128, 128, 128, 128,
    109, 178, 241, 255, 231, 245, 255, 255, 128, 128, 128, 44, 130, 201, 253, 205, 192, 255, 255, 128, 128, 128,
    1, 132, 239, 251, 219, 209, 255, 165, 128, 128, 128, 94, 136, 225, 251, 218, 190, 255, 255, 128, 128, 128,
    22, 100, 174, 245, 186, 161, 255, 199, 128, 128, 128, 1, 182, 249, 255, 232, 235, 128, 128, 128, 128, 128,
    124, 143, 241, 255, 227, 234, 128, 128, 128, 128, 128, 35, 77, 181, 251, 193, 211, 255, 205, 128, 128, 128,
    1, 157, 247, 255, 236, 231, 255, 255, 128, 128, 128, 121, 141, 235, 255, 225, 227, 255, 255, 128, 128, 128,
    45, 99, 188, 251, 195, 217, 255, 224, 128, 128, 128, 1, 1, 251, 255, 213, 255, 128, 128, 128, 128, 128,
    203, 1, 248, 255, 255, 128, 128, 128, 128, 128, 128, 137, 1, 177, 255, 224, 255, 128, 128, 128, 128, 128,
    253, 9, 248, 251, 207, 208, 255, 192, 128, 128, 128, 175, 13, 224, 243, 193, 185, 249, 198, 255, 255, 128,
    73, 17, 171, 221, 161, 179, 236, 167, 255, 234, 128, 1, 95, 247, 253, 212, 183, 255, 255, 128, 128, 128,
    239, 90, 244, 250, 211, 209, 255, 255, 128, 128, 128, 155, 77, 195, 248, 188, 195, 255, 255, 128, 128, 128,
    1, 24, 239, 251, 218, 219, 255, 205, 128, 128, 128, 201, 51, 219, 255, 196, 186, 128, 128, 128, 128, 128,
    69, 46, 190, 239, 201, 218, 255, 228, 128, 128, 128, 1, 191, 251, 255, 255, 128, 128, 128, 128, 128, 128,
    223, 165, 249, 255, 213, 255, 128, 128, 128, 128, 128, 141, 124, 248, 255, 255, 128, 128, 128, 128, 128, 128,
    1, 16, 248, 255, 255, 128, 128, 128, 128, 128, 128, 190, 36, 230, 255, 236, 255, 128, 128, 128, 128, 128,
    149, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 1, 226, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    247, 192, 255, 128, 128, 128, 128, 128, 128, 128, 128, 240, 128, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    1, 134, 252, 255, 255, 128, 128, 128, 128, 128, 128, 213, 62, 250, 255, 255, 128, 128, 128, 128, 128, 128,
    55, 93, 255, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128, 128,
    202, 24, 213, 235, 186, 191, 220, 160, 240, 175, 255, 126, 38, 182, 232, 169, 184, 228, 174, 255, 187, 128,
    61, 46, 138, 219, 151, 178, 240, 170, 255, 216, 128, 1, 112, 230, 250, 199, 191, 247, 159, 255, 255, 128,
    166, 109, 228, 252, 211, 215, 255, 174, 128, 128, 128, 39, 77, 162, 232, 172, 180, 245, 178, 255, 255, 128,
    1, 52, 220, 246, 198, 199, 249, 220, 255, 255, 128, 124, 74, 191, 243, 183, 193, 250, 221, 255, 255, 128,
    24, 71, 130, 219, 154, 170, 243, 182, 255, 255, 128, 1, 182, 225, 249, 219, 240, 255, 224, 128, 128, 128,
    149, 150, 226, 252, 216, 205, 255, 171, 128, 128, 128, 28, 108, 170, 242, 183, 194, 254, 223, 255, 255, 128,
    1, 81, 230, 252, 204, 203, 255, 192, 128, 128, 128, 123, 102, 209, 247, 188, 196, 255, 233, 128, 128, 128,
    20, 95, 153, 243, 164, 173, 255, 203, 128, 128, 128, 1, 222, 248, 255, 216, 213, 128, 128, 128, 128, 128,
    168, 175, 246, 252, 235, 205, 255, 255, 128, 128, 128, 47, 116, 215, 255, 211, 212, 255, 255, 128, 128, 128,
    1, 121, 236, 253, 212, 214, 255, 255, 128, 128, 128, 141, 84, 213, 252, 201, 202, 255, 219, 128, 128, 128,
    42, 80, 160, 240, 162, 185, 255, 205, 128, 128, 128, 1, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128,
    244, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128, 238, 1, 255, 128, 128, 128, 128, 128, 128, 128, 128};
const uint8_t kCoeffsUpdateProba[1056] = {
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 176, 246, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 241, 252, 255, 255, 255, 255, 255, 255, 255, 255, 249, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 244, 252, 255, 255, 255, 255, 255, 255, 255, 255, 234, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 246, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    239, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    251, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 254, 255, 255, 255, 255, 255, 255, 250, 255, 254, 255, 254, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    217, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 225, 252, 241, 253, 255, 255, 254, 255, 255, 255, 255,
    234, 250, 241, 250, 253, 255, 253, 254, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    223, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 238, 253, 254, 254, 255, 255, 255, 255, 255, 255, 255,
    255, 248, 254, 255, 255, 255, 255, 255, 255, 255, 255, 249, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    247, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    186, 251, 250, 255, 255, 255, 255, 255, 255, 255, 255, 234, 251, 244, 254, 255, 255, 255, 255, 255, 255, 255,
    251, 251, 243, 253, 254, 255, 254, 255, 255, 255, 255, 255, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    236, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 253, 253, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 254, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    248, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 250, 254, 252, 254, 255, 255, 255, 255, 255, 255, 255,
    248, 254, 249, 253, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    246, 253, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 254, 251, 254, 254, 255, 255, 255, 255, 255, 255,
    255, 254, 252, 255, 255, 255, 255, 255, 255, 255, 255, 248, 254, 253, 255, 255, 255, 255, 255, 255, 255, 255,
    253, 255, 254, 254, 255, 255, 255, 255, 255, 255, 255, 255, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    245, 251, 254, 255, 255, 255, 255, 255, 255, 255, 255, 253, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 251, 253, 255, 255, 255, 255, 255, 255, 255, 255, 252, 253, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 252, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    249, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 254, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 253, 255, 255, 255, 255, 255, 255, 255, 255, 250, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
    254, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255};
const uint8_t kDcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 10, 11, 12, 13, 14, 15, 16, 17, 17,
    18, 19, 20, 20, 21, 21, 22, 22, 23, 23, 24, 25, 25, 26, 27, 28,
    29, 30, 31, 32, 33, 34, 35, 36, 37, 37, 38, 39, 40, 41, 42, 43,
    44, 45, 46, 46, 47, 48, 49, 50, 51, 52, 53, 54, 55, 56, 57, 58,
    59, 60, 61, 62, 63, 64, 65, 66, 67, 68, 69, 70, 71, 72, 73, 74,
    75, 76, 76, 77, 78, 79, 80, 81, 82, 83, 84, 85, 86, 87, 88, 89,
    91, 93, 95, 96, 98, 100, 101, 102, 104, 106, 108, 110, 112, 114, 116, 118,
    122, 124, 126, 128, 130, 132, 134, 136, 138, 140, 143, 145, 148, 151, 154, 157};
const uint16_t kAcTable[128] = {
    4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19,
    20, 21, 22, 23, 24, 25, 26, 27, 28, 29, 30, 31, 32, 33, 34, 35,
    36, 37, 38, 39, 40, 41, 42, 43, 44, 45, 46, 47, 48, 49, 50, 51,
    52, 53, 54, 55, 56, 57, 58, 60, 62, 64, 66, 68, 70, 72, 74, 76,
    78, 80, 82, 84, 86, 88, 90, 92, 94, 96, 98, 100, 102, 104, 106, 108,
    110, 112, 114, 116, 119, 122, 125, 128, 131, 134, 137, 140, 143, 146, 149, 152,
    155, 158, 161, 164, 167, 170, 173, 177, 181, 185, 189, 193, 197, 201, 205, 209,
    213, 217, 221, 225, 229, 234, 239, 245, 249, 254, 259, 264, 269, 274, 279, 284};
const uint8_t kCodeToPlane[120] = {
    24, 7, 23, 25, 40, 6, 39, 41, 22, 26, 38, 42, 56, 5, 55, 57, 21, 27, 54, 58,
    37, 43, 72, 4, 71, 73, 20, 28, 53, 59, 70, 74, 36, 44, 88, 69, 75, 52, 60, 3,
    87, 89, 19, 29, 86, 90, 35, 45, 68, 76, 85, 91, 51, 61, 104, 2, 103, 105, 18, 30,
    102, 106, 34, 46, 84, 92, 67, 77, 101, 107, 50, 62, 120, 1, 119, 121, 83, 93, 17, 31,
    100, 108, 66, 78, 118, 122, 33, 47, 117, 123, 49, 63, 99, 109, 82, 94, 0, 116, 124, 65,
    79, 16, 32, 98, 110, 48, 115, 125, 81, 95, 64, 114, 126, 97, 111, 80, 113, 127, 96, 112};

// ---- VP8L -----------------------------------------------------------------

// LSB-first bits; reads past the end give zeros (and mark eof)
struct LBits {
  const uint8_t* p;
  size_t n;
  size_t pos = 0;
  uint64_t window(size_t at) const {
    uint64_t v = 0;
    const size_t b = at / 8;
    for (int i = 0; i < 8; ++i)
      if (b + i < n) v |= static_cast<uint64_t>(p[b + i]) << (8 * i);
    return v >> (at % 8);
  }
  uint32_t peek(int k) const { return static_cast<uint32_t>(window(pos) & ((uint64_t(1) << k) - 1)); }
  uint32_t read(int k) {
    if (k == 0) return 0;
    const uint32_t v = peek(k);
    pos += k;
    return v;
  }
  bool eof() const { return pos > 8 * n; }
};

constexpr int kFastBits = 10;

// a canonical prefix code (Deflate's order: by length, then symbol)
struct Prefix {
  int single = -1;  // a code of one symbol: no bits
  std::vector<uint16_t> fast;  // kFastBits peeked bits -> symbol << 4 | length (0: slow path)
  int counts[16] = {0};
  std::vector<uint16_t> sorted;
  void build(const std::vector<int>& lengths) {
    int used = 0, last = 0;
    for (size_t s = 0; s < lengths.size(); ++s)
      if (lengths[s]) {
        ++used;
        last = static_cast<int>(s);
      }
    if (used == 0) fail(2, "a VP8L prefix code with no symbols");
    if (used == 1) {
      single = last;
      return;
    }
    for (int l : lengths) ++counts[l];
    counts[0] = 0;
    int offs[16];
    offs[1] = 0;
    for (int l = 1; l < 15; ++l) offs[l + 1] = offs[l] + counts[l];
    sorted.assign(used, 0);
    for (size_t s = 0; s < lengths.size(); ++s)
      if (lengths[s]) sorted[offs[lengths[s]]++] = static_cast<uint16_t>(s);
    // check the code is complete
    int left = 1;
    for (int l = 1; l < 16; ++l) {
      left = left * 2 - counts[l];
      if (left < 0) fail(2, "an over-subscribed VP8L prefix code");
    }
    if (left != 0) fail(2, "an incomplete VP8L prefix code");
    fast.assign(1 << kFastBits, 0);
    int code = 0, index = 0;
    for (int l = 1; l <= kFastBits; ++l) {
      for (int i = 0; i < counts[l]; ++i, ++code) {
        int rev = 0;
        for (int b = 0; b < l; ++b) rev |= ((code >> b) & 1) << (l - 1 - b);
        for (int v = rev; v < (1 << kFastBits); v += 1 << l)
          fast[v] = static_cast<uint16_t>(sorted[index + i] << 4 | l);
      }
      index += counts[l];
      code <<= 1;
    }
  }
  int decode(LBits& in) const {
    if (single >= 0) return single;
    const uint16_t f = fast[in.peek(kFastBits)];
    if (f & 15) {
      in.pos += f & 15;
      return f >> 4;
    }
    int code = 0, first = 0, index = 0;
    for (int l = 1; l < 16; ++l) {
      code |= static_cast<int>(in.read(1));
      const int count = counts[l];
      if (code - count < first) return sorted[index + (code - first)];
      index += count;
      first = (first + count) << 1;
      code <<= 1;
    }
    fail(2, "a bad VP8L prefix code");
  }
};

const int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15};

void read_prefix(LBits& in, int alphabet, Prefix& out) {
  std::vector<int> lengths(alphabet, 0);
  if (in.read(1)) {  // simple code
    const int num = static_cast<int>(in.read(1)) + 1;
    const int first_bits = in.read(1) ? 8 : 1;
    const int s0 = static_cast<int>(in.read(first_bits));
    if (s0 >= alphabet) fail(2, "a VP8L simple code symbol out of range");
    lengths[s0] = 1;
    if (num == 2) {
      const int s1 = static_cast<int>(in.read(8));
      if (s1 >= alphabet) fail(2, "a VP8L simple code symbol out of range");
      lengths[s1] = 1;
    }
  } else {
    std::vector<int> cl(19, 0);
    const int num = static_cast<int>(in.read(4)) + 4;
    for (int i = 0; i < num; ++i) cl[kCodeLengthOrder[i]] = static_cast<int>(in.read(3));
    Prefix lc;
    lc.build(cl);
    int max_symbol = alphabet;
    if (in.read(1)) {
      const int nbits = 2 + 2 * static_cast<int>(in.read(3));
      max_symbol = 2 + static_cast<int>(in.read(nbits));
      if (max_symbol > alphabet) fail(2, "a VP8L code length count out of range");
    }
    int symbol = 0, prev = 8;
    while (symbol < alphabet) {
      if (max_symbol-- == 0) break;
      const int len = lc.decode(in);
      if (len < 16) {
        lengths[symbol++] = len;
        if (len) prev = len;
      } else {
        static const int kExtra[3] = {2, 3, 7}, kOffset[3] = {3, 3, 11};
        int repeat = static_cast<int>(in.read(kExtra[len - 16])) + kOffset[len - 16];
        if (symbol + repeat > alphabet) fail(2, "a VP8L code length repeat out of range");
        const int value = len == 16 ? prev : 0;
        while (repeat-- > 0) lengths[symbol++] = value;
      }
    }
  }
  out.build(lengths);
}

inline int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

inline uint32_t add_pixels(uint32_t a, uint32_t b) {
  const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
  const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
  return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
}
inline uint32_t average2(uint32_t a, uint32_t b) { return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b); }
inline int clip255(int v) { return v < 0 ? 0 : v > 255 ? 255 : v; }
inline uint32_t clamp_add_subtract_full(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8)
    out |= static_cast<uint32_t>(clip255(static_cast<int>((a >> s) & 255) + static_cast<int>((b >> s) & 255) -
                                         static_cast<int>((c >> s) & 255)))
           << s;
  return out;
}
inline uint32_t clamp_add_subtract_half(uint32_t a, uint32_t b) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int x = static_cast<int>((a >> s) & 255), y = static_cast<int>((b >> s) & 255);
    out |= static_cast<uint32_t>(clip255(x + (x - y) / 2)) << s;
  }
  return out;
}
inline uint32_t select_pixel(uint32_t left, uint32_t top, uint32_t tl) {
  int p_left = 0, p_top = 0;
  for (int s = 0; s < 32; s += 8) {
    const int l = static_cast<int>((left >> s) & 255), t = static_cast<int>((top >> s) & 255),
              c = static_cast<int>((tl >> s) & 255);
    p_left += std::abs(t - c);  // |estimate - L| with estimate = L + T - TL
    p_top += std::abs(l - c);
  }
  return p_left < p_top ? left : top;
}

uint32_t predict(int mode, const uint32_t* px, int width) {
  const uint32_t left = px[-1], top = px[-width], tr = px[-width + 1], tl = px[-width - 1];
  switch (mode) {
    case 1: return left;
    case 2: return top;
    case 3: return tr;
    case 4: return tl;
    case 5: return average2(average2(left, tr), top);
    case 6: return average2(left, tl);
    case 7: return average2(left, top);
    case 8: return average2(tl, top);
    case 9: return average2(top, tr);
    case 10: return average2(average2(left, tl), average2(top, tr));
    case 11: return select_pixel(left, top, tl);
    case 12: return clamp_add_subtract_full(left, top, tl);
    case 13: return clamp_add_subtract_half(average2(left, top), tl);
    default: return 0xff000000u;
  }
}

struct Transform {
  int type, bits, xsize, ysize;
  std::vector<uint32_t> data;
};

struct Lossless {
  LBits in;
  int seen = 0;

  // an entropy-coded image of xsize x ysize; level 0 has transforms and meta codes
  std::vector<uint32_t> image(int xsize, int ysize, bool level0) {
    std::vector<Transform> transforms;
    int width = xsize;
    if (level0) {
      while (in.read(1)) {
        Transform t;
        t.type = static_cast<int>(in.read(2));
        if (seen & (1 << t.type)) fail(2, "a VP8L transform used twice");
        seen |= 1 << t.type;
        t.xsize = width;
        t.ysize = ysize;
        t.bits = 0;
        if (t.type == 0 || t.type == 1) {
          t.bits = static_cast<int>(in.read(3)) + 2;
          t.data = image(subsample(width, t.bits), subsample(ysize, t.bits), false);
        } else if (t.type == 3) {
          const int colors = static_cast<int>(in.read(8)) + 1;
          t.bits = colors > 16 ? 0 : colors > 4 ? 1 : colors > 2 ? 2 : 3;
          std::vector<uint32_t> pal = image(colors, 1, false);
          const int size = t.bits ? 1 << (8 >> t.bits) : 256;
          t.data.assign(size, 0);
          for (int i = 0; i < colors && i < size; ++i) t.data[i] = i ? add_pixels(pal[i], t.data[i - 1]) : pal[0];
          width = subsample(width, t.bits);
        }
        transforms.push_back(std::move(t));
      }
    }
    int cache_bits = 0;
    if (in.read(1)) {
      cache_bits = static_cast<int>(in.read(4));
      if (cache_bits < 1 || cache_bits > 11) fail(2, "a VP8L colour cache size out of range");
    }
    int meta_bits = 0, meta_width = 0;
    std::vector<uint32_t> meta;
    int groups = 1;
    if (level0 && in.read(1)) {
      meta_bits = static_cast<int>(in.read(3)) + 2;
      meta_width = subsample(width, meta_bits);
      meta = image(meta_width, subsample(ysize, meta_bits), false);
      for (uint32_t& m : meta) {
        m = (m >> 8) & 0xffff;
        if (static_cast<int>(m) + 1 > groups) groups = static_cast<int>(m) + 1;
      }
    }
    const int cache_size = cache_bits ? 1 << cache_bits : 0;
    std::vector<Prefix> codes(5 * static_cast<size_t>(groups));
    for (int g = 0; g < groups; ++g) {
      read_prefix(in, 256 + 24 + cache_size, codes[5 * g + 0]);
      read_prefix(in, 256, codes[5 * g + 1]);
      read_prefix(in, 256, codes[5 * g + 2]);
      read_prefix(in, 256, codes[5 * g + 3]);
      read_prefix(in, 40, codes[5 * g + 4]);
    }
    std::vector<uint32_t> cache(cache_size, 0);
    const size_t total = static_cast<size_t>(width) * ysize;
    std::vector<uint32_t> px(total, 0);
    size_t pos = 0, cached = 0;
    auto insert = [&](size_t upto) {
      if (!cache_size) return;
      for (; cached < upto; ++cached) cache[(0x1e35a7bdu * px[cached]) >> (32 - cache_bits)] = px[cached];
    };
    const Prefix* g = codes.data();
    while (pos < total) {
      const int x = static_cast<int>(pos % width), y = static_cast<int>(pos / width);
      if (meta_bits) g = codes.data() + 5 * meta[(y >> meta_bits) * meta_width + (x >> meta_bits)];
      const int code = g[0].decode(in);
      if (code < 256) {
        const uint32_t red = g[1].decode(in), blue = g[2].decode(in), alpha = g[3].decode(in);
        px[pos++] = (alpha << 24) | (red << 16) | (static_cast<uint32_t>(code) << 8) | blue;
      } else if (code < 256 + 24) {
        auto copy_value = [&](int prefix) -> size_t {
          if (prefix < 4) return static_cast<size_t>(prefix) + 1;
          const int extra = (prefix - 2) >> 1;
          const size_t offset = static_cast<size_t>(2 + (prefix & 1)) << extra;
          return offset + in.read(extra) + 1;
        };
        const size_t length = copy_value(code - 256);
        const size_t plane = copy_value(g[4].decode(in));
        size_t dist;
        if (plane > 120) {
          dist = plane - 120;
        } else {
          const int c = kCodeToPlane[plane - 1];
          const long d = static_cast<long>(c >> 4) * width + (8 - (c & 15));
          dist = d >= 1 ? static_cast<size_t>(d) : 1;
        }
        if (dist > pos || pos + length > total) fail(2, "a VP8L backward reference out of the image");
        for (size_t k = 0; k < length; ++k, ++pos) px[pos] = px[pos - dist];
      } else {
        const int key = code - 280;
        if (key >= cache_size) fail(2, "a VP8L colour cache index out of range");
        insert(pos);
        px[pos++] = cache[key];
      }
      insert(pos);
      if (in.eof()) fail(2, "truncated VP8L data");
    }
    for (size_t i = transforms.size(); i-- > 0;) px = inverse(transforms[i], px);
    return px;
  }

  static std::vector<uint32_t> inverse(const Transform& t, std::vector<uint32_t>& px) {
    const int w = t.xsize, h = t.ysize;
    if (t.type == 2) {
      for (uint32_t& p : px) {
        const uint32_t green = (p >> 8) & 255;
        p = (p & 0xff00ff00u) | ((((p >> 16) + green) & 255) << 16) | (((p & 255) + green) & 255);
      }
      return std::move(px);
    }
    if (t.type == 0) {
      const int tiles = subsample(w, t.bits);
      uint32_t* d = px.data();
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
          uint32_t* p = d + static_cast<size_t>(y) * w + x;
          uint32_t pred;
          if (y == 0)
            pred = x == 0 ? 0xff000000u : p[-1];
          else if (x == 0)
            pred = p[-w];
          else
            pred = predict((t.data[(y >> t.bits) * tiles + (x >> t.bits)] >> 8) & 15, p, w);
          *p = add_pixels(*p, pred);
        }
      return std::move(px);
    }
    if (t.type == 1) {
      const int tiles = subsample(w, t.bits);
      for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x) {
          uint32_t& p = px[static_cast<size_t>(y) * w + x];
          const uint32_t m = t.data[(y >> t.bits) * tiles + (x >> t.bits)];
          const int g2r = static_cast<int8_t>(m & 255), g2b = static_cast<int8_t>((m >> 8) & 255),
                    r2b = static_cast<int8_t>((m >> 16) & 255);
          const int green = static_cast<int8_t>((p >> 8) & 255);
          int red = static_cast<int>((p >> 16) & 255), blue = static_cast<int>(p & 255);
          red = (red + ((g2r * green) >> 5)) & 255;
          blue = (blue + ((g2b * green) >> 5) + ((r2b * static_cast<int8_t>(red)) >> 5)) & 255;
          p = (p & 0xff00ff00u) | (static_cast<uint32_t>(red) << 16) | static_cast<uint32_t>(blue);
        }
      return std::move(px);
    }
    // colour indexing: the packed width -> the full width
    const int packed = subsample(w, t.bits), per = 1 << t.bits, bits = 8 >> t.bits;
    std::vector<uint32_t> out(static_cast<size_t>(w) * h);
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        const uint32_t idx = (px[static_cast<size_t>(y) * packed + x / per] >> 8) & 255;
        const uint32_t v = t.bits ? (idx >> ((x % per) * bits)) & ((1u << bits) - 1) : idx;
        out[static_cast<size_t>(y) * w + x] = t.data[v];
      }
    return out;
  }
};

// a VP8L stream with its header -> ARGB
std::vector<uint32_t> decode_vp8l(const uint8_t* p, size_t n, int* width, int* height, bool* alpha) {
  if (n < 5 || p[0] != 0x2f) fail(2, "not a VP8L stream");
  Lossless d{LBits{p, n}};
  d.in.pos = 8;
  *width = static_cast<int>(d.in.read(14)) + 1;
  *height = static_cast<int>(d.in.read(14)) + 1;
  *alpha = d.in.read(1) != 0;
  if (d.in.read(3) != 0) fail(2, "a VP8L version other than 0");
  return d.image(*width, *height, true);
}


// ---- VP8 ------------------------------------------------------------------

struct BoolDecoder {
  const uint8_t* p;
  const uint8_t* end;
  uint32_t value = 0, range = 255;
  int bit_count = 0;
  BoolDecoder() : p(nullptr), end(nullptr) {}
  BoolDecoder(const uint8_t* s, size_t n) : p(s), end(s + n) {
    value = (static_cast<uint32_t>(next()) << 8) | next();
  }
  uint8_t next() { return p < end ? *p++ : 0; }
  int bit(int prob) {
    const uint32_t split = 1 + (((range - 1) * static_cast<uint32_t>(prob)) >> 8);
    const uint32_t big = split << 8;
    int r;
    if (value >= big) {
      r = 1;
      range -= split;
      value -= big;
    } else {
      r = 0;
      range = split;
    }
    while (range < 128) {
      value <<= 1;
      range <<= 1;
      if (++bit_count == 8) {
        bit_count = 0;
        value |= next();
      }
    }
    return r;
  }
  int literal(int n) {
    int v = 0;
    while (n-- > 0) v = (v << 1) | bit(128);
    return v;
  }
  int signed_value(int n) {
    const int v = literal(n);
    return bit(128) ? -v : v;
  }
};

const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15};
const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0};
const uint8_t kCat3[] = {173, 148, 140, 0}, kCat4[] = {176, 155, 140, 135, 0},
              kCat5[] = {180, 157, 141, 134, 130, 0},
              kCat6[] = {254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129, 0};
const uint8_t* const kCat3456[4] = {kCat3, kCat4, kCat5, kCat6};
// libwebp's order of the 4x4 modes (kBModesProba is indexed by it)
enum { B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU };
const int8_t kYModesIntra4[18] = {-B_DC, 1, -B_TM, 2, -B_VE, 3, 4, 6, -B_HE, 5, -B_RD, -B_VR, -B_LD, 7, -B_VL, 8, -B_HD, -B_HU};

inline uint8_t clip8(int v) { return static_cast<uint8_t>(v < 0 ? 0 : v > 255 ? 255 : v); }

struct MacroBlock {
  int segment = 0, skip = 0, i4x4 = 0, ymode = 0, uvmode = 0;
  uint8_t modes[16];
  int16_t coeffs[384];
};

struct Lossy {
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  // segment and filter headers
  int use_segment = 0, update_map = 0, absolute_delta = 0;
  int quantizer[4] = {0, 0, 0, 0}, filter_strength[4] = {0, 0, 0, 0};
  uint8_t segment_probs[3] = {255, 255, 255};
  int simple = 0, level = 0, sharpness = 0, use_lf_delta = 0;
  int ref_lf_delta[4] = {0, 0, 0, 0}, mode_lf_delta[4] = {0, 0, 0, 0};
  int filter_type = 0;
  int use_skip = 0, skip_p = 0;
  uint8_t proba[4][8][3][11];
  int y1[4][2], y2[4][2], uv[4][2];
  std::vector<BoolDecoder> parts;
  BoolDecoder br;
  // planes of the macroblock grid, unfiltered while predicting
  int ystride = 0, uvstride = 0;
  std::vector<uint8_t> Y, U, V;

  void header(const uint8_t* p, size_t n) {
    if (n < 10) fail(2, "truncated VP8 frame header");
    const uint32_t tag = p[0] | (p[1] << 8) | (p[2] << 16);
    if (tag & 1) fail(1, "a VP8 frame that is not a key frame");
    if (((tag >> 1) & 7) > 3) fail(2, "a VP8 profile out of range");
    const size_t first = tag >> 5;
    if (p[3] != 0x9d || p[4] != 0x01 || p[5] != 0x2a) fail(2, "a VP8 key frame without its start code");
    width = (p[6] | (p[7] << 8)) & 0x3fff;
    height = (p[8] | (p[9] << 8)) & 0x3fff;
    if (!width || !height) fail(2, "a VP8 frame of no pixels");
    mb_w = (width + 15) >> 4;
    mb_h = (height + 15) >> 4;
    if (10 + first > n) fail(2, "truncated VP8 first partition");
    br = BoolDecoder(p + 10, first);
    br.bit(128);  // colour space
    br.bit(128);  // clamping type
    use_segment = br.bit(128);
    if (use_segment) {
      update_map = br.bit(128);
      if (br.bit(128)) {
        absolute_delta = br.bit(128);
        for (int& q : quantizer) q = br.bit(128) ? br.signed_value(7) : 0;
        for (int& f : filter_strength) f = br.bit(128) ? br.signed_value(6) : 0;
      }
      if (update_map)
        for (uint8_t& s : segment_probs) s = static_cast<uint8_t>(br.bit(128) ? br.literal(8) : 255);
    }
    simple = br.bit(128);
    level = br.literal(6);
    sharpness = br.literal(3);
    use_lf_delta = br.bit(128);
    if (use_lf_delta && br.bit(128)) {
      for (int& d : ref_lf_delta)
        if (br.bit(128)) d = br.signed_value(6);
      for (int& d : mode_lf_delta)
        if (br.bit(128)) d = br.signed_value(6);
    }
    filter_type = level == 0 ? 0 : simple ? 1 : 2;
    // token partitions
    const int num = 1 << br.literal(2);
    const uint8_t* sizes = p + 10 + first;
    const uint8_t* data = sizes + 3 * (num - 1);
    const uint8_t* end = p + n;
    if (data > end) fail(2, "truncated VP8 partition sizes");
    for (int i = 0; i < num; ++i) {
      size_t size = i < num - 1 ? (sizes[3 * i] | (sizes[3 * i + 1] << 8) | (sizes[3 * i + 2] << 16))
                                : static_cast<size_t>(end - data);
      if (data + size > end) size = static_cast<size_t>(end - data);
      parts.emplace_back(data, size);
      data += size;
    }
    // quantizers
    const int base = br.literal(7);
    auto delta = [&]() { return br.bit(128) ? br.signed_value(4) : 0; };
    const int dy1_dc = delta(), dy2_dc = delta(), dy2_ac = delta(), duv_dc = delta(), duv_ac = delta();
    auto clip = [](int v, int m) { return v < 0 ? 0 : v > m ? m : v; };
    for (int s = 0; s < 4; ++s) {
      int q;
      if (use_segment) {
        q = quantizer[s] + (absolute_delta ? 0 : base);
      } else if (s > 0) {
        std::memcpy(y1[s], y1[0], sizeof(y1[0]));
        std::memcpy(y2[s], y2[0], sizeof(y2[0]));
        std::memcpy(uv[s], uv[0], sizeof(uv[0]));
        continue;
      } else {
        q = base;
      }
      y1[s][0] = kDcTable[clip(q + dy1_dc, 127)];
      y1[s][1] = kAcTable[clip(q, 127)];
      y2[s][0] = kDcTable[clip(q + dy2_dc, 127)] * 2;
      y2[s][1] = (kAcTable[clip(q + dy2_ac, 127)] * 101581) >> 16;
      if (y2[s][1] < 8) y2[s][1] = 8;
      uv[s][0] = kDcTable[clip(q + duv_dc, 117)];
      uv[s][1] = kAcTable[clip(q + duv_ac, 127)];
    }
    br.bit(128);  // refresh entropy probs: a still image has one frame
    const uint8_t* p0 = kCoeffsProba0;
    const uint8_t* up = kCoeffsUpdateProba;
    for (int t = 0; t < 4; ++t)
      for (int b = 0; b < 8; ++b)
        for (int c = 0; c < 3; ++c)
          for (int k = 0; k < 11; ++k, ++p0, ++up)
            proba[t][b][c][k] = static_cast<uint8_t>(br.bit(*up) ? br.literal(8) : *p0);
    use_skip = br.bit(128);
    if (use_skip) skip_p = br.literal(8);
  }

  // tokens of one 4x4 block from position n; returns the position after the last non-zero one
  int coeffs(BoolDecoder& b, int type, int ctx, const int* dq, int n, int16_t* out) {
    const uint8_t* p = proba[type][kBands[n]][ctx];
    for (; n < 16; ++n) {
      if (!b.bit(p[0])) return n;
      while (!b.bit(p[1])) {
        if (++n == 16) return 16;
        p = proba[type][kBands[n]][0];
      }
      int v;
      const int band = kBands[n + 1];
      if (!b.bit(p[2])) {
        v = 1;
        p = proba[type][band][1];
      } else {
        if (!b.bit(p[3])) {
          v = !b.bit(p[4]) ? 2 : 3 + b.bit(p[5]);
        } else if (!b.bit(p[6])) {
          v = !b.bit(p[7]) ? 5 + b.bit(159) : 7 + 2 * b.bit(165) + b.bit(145);
        } else {
          const int bit1 = b.bit(p[8]);
          const int bit0 = b.bit(p[9 + bit1]);
          const int cat = 2 * bit1 + bit0;
          v = 0;
          for (const uint8_t* tab = kCat3456[cat]; *tab; ++tab) v += v + b.bit(*tab);
          v += 3 + (8 << cat);
        }
        p = proba[type][band][2];
      }
      out[kZigzag[n]] = static_cast<int16_t>((b.bit(128) ? -v : v) * dq[n > 0]);
    }
    return 16;
  }

  void decode() {
    ystride = mb_w * 16;
    uvstride = mb_w * 8;
    Y.assign(static_cast<size_t>(ystride) * mb_h * 16, 0);
    U.assign(static_cast<size_t>(uvstride) * mb_h * 8, 0);
    V.assign(static_cast<size_t>(uvstride) * mb_h * 8, 0);
    std::vector<uint8_t> intra_t(4 * mb_w, B_DC);
    // non-zero contexts: per column (above) and the left neighbour; 4 Y, 2 U, 2 V, and the Y2 DC
    std::vector<uint8_t> nz_top(9 * mb_w, 0);
    // filter info per macroblock: limit, interior, hev threshold, inner edges
    struct FInfo {
      int limit, ilevel, hev, inner;
    };
    std::vector<FInfo> finfo(static_cast<size_t>(mb_w) * mb_h);
    FInfo fstrength[4][2];
    for (int s = 0; s < 4; ++s) {
      int base_level = use_segment ? filter_strength[s] + (absolute_delta ? 0 : level) : level;
      for (int i4 = 0; i4 <= 1; ++i4) {
        int lvl = base_level;
        if (use_lf_delta) {
          lvl += ref_lf_delta[0];
          if (i4) lvl += mode_lf_delta[0];
        }
        lvl = lvl < 0 ? 0 : lvl > 63 ? 63 : lvl;
        FInfo& f = fstrength[s][i4];
        if (lvl > 0) {
          int ilevel = lvl;
          if (sharpness > 0) {
            ilevel >>= sharpness > 4 ? 2 : 1;
            if (ilevel > 9 - sharpness) ilevel = 9 - sharpness;
          }
          if (ilevel < 1) ilevel = 1;
          f = FInfo{2 * lvl + ilevel, ilevel, lvl >= 40 ? 2 : lvl >= 15 ? 1 : 0, i4};
        } else {
          f = FInfo{0, 0, 0, i4};
        }
      }
    }
    MacroBlock mb;
    for (int my = 0; my < mb_h; ++my) {
      uint8_t intra_l[4] = {B_DC, B_DC, B_DC, B_DC};
      uint8_t nz_left[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
      BoolDecoder& tb = parts[my & (parts.size() - 1)];
      for (int mx = 0; mx < mb_w; ++mx) {
        // modes (first partition)
        mb.segment = update_map ? (!br.bit(segment_probs[0]) ? br.bit(segment_probs[1])
                                                             : br.bit(segment_probs[2]) + 2)
                                : 0;
        mb.skip = use_skip ? br.bit(skip_p) : 0;
        uint8_t* top = &intra_t[4 * mx];
        mb.i4x4 = !br.bit(145);
        if (!mb.i4x4) {
          const int ymode = br.bit(156) ? (br.bit(128) ? B_TM : B_HE) : (br.bit(163) ? B_VE : B_DC);
          mb.ymode = ymode;
          std::memset(top, ymode, 4);
          std::memset(intra_l, ymode, 4);
        } else {
          for (int y = 0; y < 4; ++y) {
            int ymode = intra_l[y];
            for (int x = 0; x < 4; ++x) {
              const uint8_t* prob = kBModesProba + (top[x] * 10 + ymode) * 9;
              int i = kYModesIntra4[br.bit(prob[0])];
              while (i > 0) i = kYModesIntra4[2 * i + br.bit(prob[i])];
              ymode = -i;
              top[x] = static_cast<uint8_t>(ymode);
              mb.modes[4 * y + x] = static_cast<uint8_t>(ymode);
            }
            intra_l[y] = static_cast<uint8_t>(ymode);
          }
        }
        mb.uvmode = !br.bit(142) ? B_DC : !br.bit(114) ? B_VE : br.bit(183) ? B_TM : B_HE;
        // residuals (the row's token partition)
        std::memset(mb.coeffs, 0, sizeof(mb.coeffs));
        uint8_t* nt = &nz_top[9 * mx];
        int skip = mb.skip;
        if (!skip) {
          const int* q1 = y1[mb.segment];
          int first = 0, type = 3;
          bool any = false;
          if (!mb.i4x4) {
            int16_t dc[16] = {0};
            const int nz = coeffs(tb, 1, nt[8] + nz_left[8], y2[mb.segment], 0, dc);
            nt[8] = nz_left[8] = nz > 0;
            if (nz > 1) {
              wht(dc, mb.coeffs);
            } else {
              const int dc0 = (dc[0] + 3) >> 3;
              for (int i = 0; i < 256; i += 16) mb.coeffs[i] = static_cast<int16_t>(dc0);
            }
            for (int i = 0; i < 256; i += 16) any |= mb.coeffs[i] != 0;
            first = 1;
            type = 0;
          }
          for (int y = 0; y < 4; ++y)
            for (int x = 0; x < 4; ++x) {
              int16_t* out = mb.coeffs + 16 * (4 * y + x);
              const int nz = coeffs(tb, type, nt[x] + nz_left[y], q1, first, out);
              nt[x] = nz_left[y] = nz > first;
              any |= nz > first;
              if (nz > 0 && first == 0) any = true;
            }
          for (int ch = 0; ch < 2; ++ch)
            for (int y = 0; y < 2; ++y)
              for (int x = 0; x < 2; ++x) {
                int16_t* out = mb.coeffs + 256 + 64 * ch + 16 * (2 * y + x);
                const int nz = coeffs(tb, 2, nt[4 + 2 * ch + x] + nz_left[4 + 2 * ch + y], uv[mb.segment], 0, out);
                nt[4 + 2 * ch + x] = nz_left[4 + 2 * ch + y] = nz > 0;
                any |= nz > 0;
              }
          skip = !any;
        } else {
          for (int k = 0; k < 8; ++k) nt[k] = nz_left[k] = 0;
          if (!mb.i4x4) nt[8] = nz_left[8] = 0;
        }
        if (filter_type > 0) {
          FInfo f = fstrength[mb.segment][mb.i4x4];
          f.inner |= !skip;
          finfo[static_cast<size_t>(my) * mb_w + mx] = f;
        }
        reconstruct(mb, mx, my);
      }
    }
    if (filter_type > 0)
      for (int my = 0; my < mb_h; ++my)
        for (int mx = 0; mx < mb_w; ++mx) {
          const FInfo& f = finfo[static_cast<size_t>(my) * mb_w + mx];
          filter(mx, my, f.limit, f.ilevel, f.hev, f.inner);
        }
  }

  static void wht(const int16_t* in, int16_t* out) {
    int tmp[16];
    for (int i = 0; i < 4; ++i) {
      const int a0 = in[0 + i] + in[12 + i], a1 = in[4 + i] + in[8 + i];
      const int a2 = in[4 + i] - in[8 + i], a3 = in[0 + i] - in[12 + i];
      tmp[0 + i] = a0 + a1;
      tmp[8 + i] = a0 - a1;
      tmp[4 + i] = a3 + a2;
      tmp[12 + i] = a3 - a2;
    }
    for (int i = 0; i < 4; ++i) {
      const int dc = tmp[0 + i * 4] + 3;
      const int a0 = dc + tmp[3 + i * 4], a1 = tmp[1 + i * 4] + tmp[2 + i * 4];
      const int a2 = tmp[1 + i * 4] - tmp[2 + i * 4], a3 = dc - tmp[3 + i * 4];
      out[0] = static_cast<int16_t>((a0 + a1) >> 3);
      out[16] = static_cast<int16_t>((a3 + a2) >> 3);
      out[32] = static_cast<int16_t>((a0 - a1) >> 3);
      out[48] = static_cast<int16_t>((a3 - a2) >> 3);
      out += 64;
    }
  }

  static void idct_add(const int16_t* in, uint8_t* dst, int stride) {
    auto mul1 = [](int a) { return ((a * 20091) >> 16) + a; };
    auto mul2 = [](int a) { return (a * 35468) >> 16; };
    int C[16];
    int* tmp = C;
    for (int i = 0; i < 4; ++i, ++in, tmp += 4) {
      const int a = in[0] + in[8], b = in[0] - in[8];
      const int c = mul2(in[4]) - mul1(in[12]), d = mul1(in[4]) + mul2(in[12]);
      tmp[0] = a + d;
      tmp[1] = b + c;
      tmp[2] = b - c;
      tmp[3] = a - d;
    }
    tmp = C;
    for (int i = 0; i < 4; ++i, ++tmp, dst += stride) {
      const int dc = tmp[0] + 4;
      const int a = dc + tmp[8], b = dc - tmp[8];
      const int c = mul2(tmp[4]) - mul1(tmp[12]), d = mul1(tmp[4]) + mul2(tmp[12]);
      dst[0] = clip8(dst[0] + ((a + d) >> 3));
      dst[1] = clip8(dst[1] + ((b + c) >> 3));
      dst[2] = clip8(dst[2] + ((b - c) >> 3));
      dst[3] = clip8(dst[3] + ((a - d) >> 3));
    }
  }

  // a block of (size + 1) rows of (1 + size + 4) samples: [0][0] the top-left corner, row 0 the top
  // (with 4 above-right samples for the luma 4x4 blocks), column 0 the left; as libwebp's work
  // buffer sees them (127 above the first row, 129 left of the first column)
  struct Edge {
    int top[21];  // [0] the corner, then the top row (and above-right)
    int left[16];
  };

  void edges(const std::vector<uint8_t>& plane, int stride, int size, int mx, int my, Edge& e) const {
    const int x0 = mx * size, y0 = my * size;
    if (my == 0) {
      for (int i = 0; i < size + 5; ++i) e.top[i] = 127;
    } else {
      const uint8_t* row = plane.data() + static_cast<size_t>(y0 - 1) * stride + x0;
      e.top[0] = mx == 0 ? 129 : row[-1];
      for (int i = 0; i < size; ++i) e.top[1 + i] = row[i];
      if (size == 16) {
        for (int i = 0; i < 4; ++i) e.top[17 + i] = mx < mb_w - 1 ? row[16 + i] : row[15];
      }
    }
    if (my == 0 && mx > 0) e.top[0] = 127;
    for (int j = 0; j < size; ++j)
      e.left[j] = mx == 0 ? 129 : plane[static_cast<size_t>(y0 + j) * stride + x0 - 1];
  }

  static void predict_block(int mode, int size, const int* top /* [-1..] */, const int* left, int corner,
                            bool has_top, bool has_left, uint8_t* dst, int stride) {
    // 16x16 / 8x8 modes
    if (mode == B_DC) {
      int dc;
      const int shift = size == 16 ? 4 : 3;
      if (has_top && has_left) {
        dc = size;
        for (int i = 0; i < size; ++i) dc += top[i] + left[i];
        dc >>= shift + 1;
      } else if (has_left) {
        dc = size / 2;
        for (int i = 0; i < size; ++i) dc += left[i];
        dc >>= shift;
      } else if (has_top) {
        dc = size / 2;
        for (int i = 0; i < size; ++i) dc += top[i];
        dc >>= shift;
      } else {
        dc = 0x80;
      }
      for (int y = 0; y < size; ++y) std::memset(dst + y * stride, dc, size);
    } else if (mode == B_TM) {
      for (int y = 0; y < size; ++y)
        for (int x = 0; x < size; ++x) dst[y * stride + x] = clip8(left[y] + top[x] - corner);
    } else if (mode == B_VE) {
      for (int y = 0; y < size; ++y)
        for (int x = 0; x < size; ++x) dst[y * stride + x] = static_cast<uint8_t>(top[x]);
    } else {
      for (int y = 0; y < size; ++y) std::memset(dst + y * stride, left[y], size);
    }
  }

  static void predict4(int mode, const int* T /* T[-1] the corner, T[0..7] */, const int* L, uint8_t* d, int s) {
    auto avg3 = [](int a, int b, int c) { return static_cast<uint8_t>((a + 2 * b + c + 2) >> 2); };
    auto avg2 = [](int a, int b) { return static_cast<uint8_t>((a + b + 1) >> 1); };
    auto D = [&](int x, int y) -> uint8_t& { return d[x + y * s]; };
    const int X = T[-1], A = T[0], B = T[1], C = T[2], Dd = T[3], E = T[4], F = T[5], G = T[6], H = T[7];
    const int I = L[0], J = L[1], K = L[2], Ll = L[3];
    switch (mode) {
      case B_DC: {
        int dc = 4;
        for (int i = 0; i < 4; ++i) dc += T[i] + L[i];
        dc >>= 3;
        for (int y = 0; y < 4; ++y)
          for (int x = 0; x < 4; ++x) D(x, y) = static_cast<uint8_t>(dc);
        break;
      }
      case B_TM:
        for (int y = 0; y < 4; ++y)
          for (int x = 0; x < 4; ++x) D(x, y) = clip8(L[y] + T[x] - X);
        break;
      case B_VE: {
        const uint8_t v[4] = {avg3(X, A, B), avg3(A, B, C), avg3(B, C, Dd), avg3(C, Dd, E)};
        for (int y = 0; y < 4; ++y)
          for (int x = 0; x < 4; ++x) D(x, y) = v[x];
        break;
      }
      case B_HE: {
        const uint8_t v[4] = {avg3(X, I, J), avg3(I, J, K), avg3(J, K, Ll), avg3(K, Ll, Ll)};
        for (int y = 0; y < 4; ++y)
          for (int x = 0; x < 4; ++x) D(x, y) = v[y];
        break;
      }
      case B_RD:
        D(0, 3) = avg3(J, K, Ll);
        D(1, 3) = D(0, 2) = avg3(I, J, K);
        D(2, 3) = D(1, 2) = D(0, 1) = avg3(X, I, J);
        D(3, 3) = D(2, 2) = D(1, 1) = D(0, 0) = avg3(A, X, I);
        D(3, 2) = D(2, 1) = D(1, 0) = avg3(B, A, X);
        D(3, 1) = D(2, 0) = avg3(C, B, A);
        D(3, 0) = avg3(Dd, C, B);
        break;
      case B_LD:
        D(0, 0) = avg3(A, B, C);
        D(1, 0) = D(0, 1) = avg3(B, C, Dd);
        D(2, 0) = D(1, 1) = D(0, 2) = avg3(C, Dd, E);
        D(3, 0) = D(2, 1) = D(1, 2) = D(0, 3) = avg3(Dd, E, F);
        D(3, 1) = D(2, 2) = D(1, 3) = avg3(E, F, G);
        D(3, 2) = D(2, 3) = avg3(F, G, H);
        D(3, 3) = avg3(G, H, H);
        break;
      case B_VR:
        D(0, 0) = D(1, 2) = avg2(X, A);
        D(1, 0) = D(2, 2) = avg2(A, B);
        D(2, 0) = D(3, 2) = avg2(B, C);
        D(3, 0) = avg2(C, Dd);
        D(0, 3) = avg3(K, J, I);
        D(0, 2) = avg3(J, I, X);
        D(0, 1) = D(1, 3) = avg3(I, X, A);
        D(1, 1) = D(2, 3) = avg3(X, A, B);
        D(2, 1) = D(3, 3) = avg3(A, B, C);
        D(3, 1) = avg3(B, C, Dd);
        break;
      case B_VL:
        D(0, 0) = avg2(A, B);
        D(1, 0) = D(0, 2) = avg2(B, C);
        D(2, 0) = D(1, 2) = avg2(C, Dd);
        D(3, 0) = D(2, 2) = avg2(Dd, E);
        D(0, 1) = avg3(A, B, C);
        D(1, 1) = D(0, 3) = avg3(B, C, Dd);
        D(2, 1) = D(1, 3) = avg3(C, Dd, E);
        D(3, 1) = D(2, 3) = avg3(Dd, E, F);
        D(3, 2) = avg3(E, F, G);
        D(3, 3) = avg3(F, G, H);
        break;
      case B_HU:
        D(0, 0) = avg2(I, J);
        D(2, 0) = D(0, 1) = avg2(J, K);
        D(2, 1) = D(0, 2) = avg2(K, Ll);
        D(1, 0) = avg3(I, J, K);
        D(3, 0) = D(1, 1) = avg3(J, K, Ll);
        D(3, 1) = D(1, 2) = avg3(K, Ll, Ll);
        D(3, 2) = D(2, 2) = D(0, 3) = D(1, 3) = D(2, 3) = D(3, 3) = static_cast<uint8_t>(Ll);
        break;
      case B_HD:
        D(0, 0) = D(2, 1) = avg2(I, X);
        D(0, 1) = D(2, 2) = avg2(J, I);
        D(0, 2) = D(2, 3) = avg2(K, J);
        D(0, 3) = avg2(Ll, K);
        D(3, 0) = avg3(A, B, C);
        D(2, 0) = avg3(X, A, B);
        D(1, 0) = D(3, 1) = avg3(I, X, A);
        D(1, 1) = D(3, 2) = avg3(J, I, X);
        D(1, 2) = D(3, 3) = avg3(K, J, I);
        D(1, 3) = avg3(Ll, K, J);
        break;
    }
  }

  void reconstruct(const MacroBlock& mb, int mx, int my) {
    Edge e;
    uint8_t* ydst = Y.data() + static_cast<size_t>(my) * 16 * ystride + mx * 16;
    edges(Y, ystride, 16, mx, my, e);
    if (mb.i4x4) {
      // the 4x4 blocks see the reconstructed samples of this macroblock; those right of the
      // macroblock's right column (rows 4, 8, 12) repeat its above-right samples
      for (int n = 0; n < 16; ++n) {
        const int bx = n & 3, by = n >> 2;
        int t[9], l[4];
        uint8_t* d = ydst + by * 4 * ystride + bx * 4;
        if (by == 0) {
          for (int i = 0; i < 9; ++i) t[i] = e.top[bx * 4 + i];
        } else {
          const uint8_t* row = d - ystride;
          t[0] = bx == 0 ? e.left[by * 4 - 1] : row[-1];
          for (int i = 0; i < 4; ++i) t[1 + i] = row[i];
          for (int i = 0; i < 4; ++i) t[5 + i] = bx < 3 ? row[4 + i] : e.top[17 + i];
        }
        for (int j = 0; j < 4; ++j) l[j] = bx == 0 ? e.left[by * 4 + j] : d[j * ystride - 1];
        predict4(mb.modes[n], t + 1, l, d, ystride);
        idct_add(mb.coeffs + 16 * n, d, ystride);
      }
    } else {
      predict_block(mb.ymode, 16, e.top + 1, e.left, e.top[0], my > 0, mx > 0, ydst, ystride);
      for (int n = 0; n < 16; ++n) idct_add(mb.coeffs + 16 * n, ydst + (n >> 2) * 4 * ystride + (n & 3) * 4, ystride);
    }
    for (int ch = 0; ch < 2; ++ch) {
      std::vector<uint8_t>& plane = ch ? V : U;
      edges(plane, uvstride, 8, mx, my, e);
      uint8_t* d = plane.data() + static_cast<size_t>(my) * 8 * uvstride + mx * 8;
      predict_block(mb.uvmode, 8, e.top + 1, e.left, e.top[0], my > 0, mx > 0, d, uvstride);
      for (int n = 0; n < 4; ++n)
        idct_add(mb.coeffs + 256 + 64 * ch + 16 * n, d + (n >> 1) * 4 * uvstride + (n & 1) * 4, uvstride);
    }
  }

  // ---- loop filter (dsp/dec.c) ----
  static int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
  static int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }
  static void filter2(uint8_t* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
  }
  static void filter4(uint8_t* p, int step) {
    const int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
    const int a = 3 * (q0 - p0);
    const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3), a3 = (a1 + 1) >> 1;
    p[-2 * step] = clip8(p1 + a3);
    p[-step] = clip8(p0 + a2);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a3);
  }
  static void filter6(uint8_t* p, int step) {
    const int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step], q2 = p[2 * step];
    const int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
    const int a1 = (27 * a + 63) >> 7, a2 = (18 * a + 63) >> 7, a3 = (9 * a + 63) >> 7;
    p[-3 * step] = clip8(p2 + a3);
    p[-2 * step] = clip8(p1 + a2);
    p[-step] = clip8(p0 + a1);
    p[0] = clip8(q0 - a1);
    p[step] = clip8(q1 - a2);
    p[2 * step] = clip8(q2 - a3);
  }
  static bool hev(const uint8_t* p, int step, int t) {
    return std::abs(p[-2 * step] - p[-step]) > t || std::abs(p[step] - p[0]) > t;
  }
  static bool needs(const uint8_t* p, int step, int t) {
    return 4 * std::abs(p[-step] - p[0]) + std::abs(p[-2 * step] - p[step]) <= t;
  }
  static bool needs2(const uint8_t* p, int step, int t, int it) {
    const int p3 = p[-4 * step], p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
    const int q0 = p[0], q1 = p[step], q2 = p[2 * step], q3 = p[3 * step];
    if (4 * std::abs(p0 - q0) + std::abs(p1 - q1) > t) return false;
    return std::abs(p3 - p2) <= it && std::abs(p2 - p1) <= it && std::abs(p1 - p0) <= it &&
           std::abs(q3 - q2) <= it && std::abs(q2 - q1) <= it && std::abs(q1 - q0) <= it;
  }
  static void simple_loop(uint8_t* p, int step, int across, int size, int thresh) {
    const int t2 = 2 * thresh + 1;
    for (int i = 0; i < size; ++i, p += across)
      if (needs(p, step, t2)) filter2(p, step);
  }
  static void loop(uint8_t* p, int step, int across, int size, int thresh, int ithresh, int hev_t, bool edge) {
    const int t2 = 2 * thresh + 1;
    for (int i = 0; i < size; ++i, p += across) {
      if (!needs2(p, step, t2, ithresh)) continue;
      if (hev(p, step, hev_t))
        filter2(p, step);
      else if (edge)
        filter6(p, step);
      else
        filter4(p, step);
    }
  }

  void filter(int mx, int my, int limit, int ilevel, int hev_t, int inner) {
    if (limit == 0) return;
    uint8_t* y = Y.data() + static_cast<size_t>(my) * 16 * ystride + mx * 16;
    const int ys = ystride;
    if (filter_type == 1) {
      if (mx > 0) simple_loop(y, 1, ys, 16, limit + 4);
      if (inner)
        for (int k = 1; k < 4; ++k) simple_loop(y + 4 * k, 1, ys, 16, limit);
      if (my > 0) simple_loop(y, ys, 1, 16, limit + 4);
      if (inner)
        for (int k = 1; k < 4; ++k) simple_loop(y + 4 * k * ys, ys, 1, 16, limit);
      return;
    }
    uint8_t* u = U.data() + static_cast<size_t>(my) * 8 * uvstride + mx * 8;
    uint8_t* v = V.data() + static_cast<size_t>(my) * 8 * uvstride + mx * 8;
    const int us = uvstride;
    if (mx > 0) {
      loop(y, 1, ys, 16, limit + 4, ilevel, hev_t, true);
      loop(u, 1, us, 8, limit + 4, ilevel, hev_t, true);
      loop(v, 1, us, 8, limit + 4, ilevel, hev_t, true);
    }
    if (inner) {
      for (int k = 1; k < 4; ++k) loop(y + 4 * k, 1, ys, 16, limit, ilevel, hev_t, false);
      loop(u + 4, 1, us, 8, limit, ilevel, hev_t, false);
      loop(v + 4, 1, us, 8, limit, ilevel, hev_t, false);
    }
    if (my > 0) {
      loop(y, ys, 1, 16, limit + 4, ilevel, hev_t, true);
      loop(u, us, 1, 8, limit + 4, ilevel, hev_t, true);
      loop(v, us, 1, 8, limit + 4, ilevel, hev_t, true);
    }
    if (inner) {
      for (int k = 1; k < 4; ++k) loop(y + 4 * k * ys, ys, 1, 16, limit, ilevel, hev_t, false);
      loop(u + 4 * us, us, 1, 8, limit, ilevel, hev_t, false);
      loop(v + 4 * us, us, 1, 8, limit, ilevel, hev_t, false);
    }
  }

  // ---- output: fancy upsampling and YUV -> RGB (dsp/upsampling.c, dsp/yuv.h) ----
  static int mult_hi(int v, int c) { return (v * c) >> 8; }
  static uint8_t yuv_clip(int v) { return static_cast<uint8_t>((v & ~16383) == 0 ? v >> 6 : v < 0 ? 0 : 255); }
  static void yuv_to_rgb(int y, int u, int v, uint8_t* rgb) {
    rgb[0] = yuv_clip(mult_hi(y, 19077) + mult_hi(v, 26149) - 14234);
    rgb[1] = yuv_clip(mult_hi(y, 19077) - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708);
    rgb[2] = yuv_clip(mult_hi(y, 19077) + mult_hi(u, 33050) - 17685);
  }

  static void upsample_pair(const uint8_t* top_y, const uint8_t* bottom_y, const uint8_t* top_u,
                            const uint8_t* top_v, const uint8_t* cur_u, const uint8_t* cur_v, uint8_t* top_dst,
                            uint8_t* bottom_dst, int len, int step) {
    auto load = [](uint8_t u, uint8_t v) { return static_cast<uint32_t>(u) | (static_cast<uint32_t>(v) << 16); };
    const int last_pair = (len - 1) >> 1;
    uint32_t tl = load(top_u[0], top_v[0]), l = load(cur_u[0], cur_v[0]);
    {
      const uint32_t uv0 = (3 * tl + l + 0x00020002u) >> 2;
      yuv_to_rgb(top_y[0], uv0 & 0xff, uv0 >> 16, top_dst);
    }
    if (bottom_y) {
      const uint32_t uv0 = (3 * l + tl + 0x00020002u) >> 2;
      yuv_to_rgb(bottom_y[0], uv0 & 0xff, uv0 >> 16, bottom_dst);
    }
    for (int x = 1; x <= last_pair; ++x) {
      const uint32_t t = load(top_u[x], top_v[x]), uv = load(cur_u[x], cur_v[x]);
      const uint32_t avg = tl + t + l + uv + 0x00080008u;
      const uint32_t diag_12 = (avg + 2 * (t + l)) >> 3, diag_03 = (avg + 2 * (tl + uv)) >> 3;
      {
        const uint32_t uv0 = (diag_12 + tl) >> 1, uv1 = (diag_03 + t) >> 1;
        yuv_to_rgb(top_y[2 * x - 1], uv0 & 0xff, uv0 >> 16, top_dst + (2 * x - 1) * step);
        yuv_to_rgb(top_y[2 * x], uv1 & 0xff, uv1 >> 16, top_dst + (2 * x) * step);
      }
      if (bottom_y) {
        const uint32_t uv0 = (diag_03 + l) >> 1, uv1 = (diag_12 + uv) >> 1;
        yuv_to_rgb(bottom_y[2 * x - 1], uv0 & 0xff, uv0 >> 16, bottom_dst + (2 * x - 1) * step);
        yuv_to_rgb(bottom_y[2 * x], uv1 & 0xff, uv1 >> 16, bottom_dst + (2 * x) * step);
      }
      tl = t;
      l = uv;
    }
    if (!(len & 1)) {
      {
        const uint32_t uv0 = (3 * tl + l + 0x00020002u) >> 2;
        yuv_to_rgb(top_y[len - 1], uv0 & 0xff, uv0 >> 16, top_dst + (len - 1) * step);
      }
      if (bottom_y) {
        const uint32_t uv0 = (3 * l + tl + 0x00020002u) >> 2;
        yuv_to_rgb(bottom_y[len - 1], uv0 & 0xff, uv0 >> 16, bottom_dst + (len - 1) * step);
      }
    }
  }

  // the frame as RGB(A) rows of `step` bytes a pixel (the alpha byte, if any, left as it is)
  void emit(uint8_t* out, int step) const {
    const size_t row = static_cast<size_t>(width) * step;
    const uint8_t* y = Y.data();
    const uint8_t* u = U.data();
    const uint8_t* v = V.data();
    upsample_pair(y, nullptr, u, v, u, v, out, nullptr, width, step);
    int r = 0;
    for (; r + 2 < height; r += 2) {
      const uint8_t* tu = u + static_cast<size_t>(r / 2) * uvstride;
      const uint8_t* tv = v + static_cast<size_t>(r / 2) * uvstride;
      upsample_pair(y + static_cast<size_t>(r + 1) * ystride, y + static_cast<size_t>(r + 2) * ystride, tu, tv,
                    tu + uvstride, tv + uvstride, out + (r + 1) * row, out + (r + 2) * row, width, step);
    }
    if (!(height & 1)) {
      const uint8_t* cu = u + static_cast<size_t>(height / 2 - 1) * uvstride;
      const uint8_t* cv = v + static_cast<size_t>(height / 2 - 1) * uvstride;
      upsample_pair(y + static_cast<size_t>(height - 1) * ystride, nullptr, cu, cv, cu, cv,
                    out + (height - 1) * row, nullptr, width, step);
    }
  }
};


// ---- ALPH (alpha_dec.c, dsp/filters.c) -----------------------------------

void unfilter_row(int method, const uint8_t* prev, const uint8_t* in, uint8_t* out, int width) {
  if (method == 0) {
    std::memcpy(out, in, width);
    return;
  }
  if (method == 1 || prev == nullptr) {  // horizontal (and every first row)
    uint8_t pred = prev == nullptr ? 0 : prev[0];
    for (int i = 0; i < width; ++i) {
      out[i] = static_cast<uint8_t>(pred + in[i]);
      pred = out[i];
    }
    return;
  }
  if (method == 2) {
    for (int i = 0; i < width; ++i) out[i] = static_cast<uint8_t>(prev[i] + in[i]);
    return;
  }
  int top = prev[0], top_left = top, left = top;
  for (int i = 0; i < width; ++i) {
    top = prev[i];
    const int g = left + top - top_left;
    left = static_cast<uint8_t>(in[i] + (g < 0 ? 0 : g > 255 ? 255 : g));
    top_left = top;
    out[i] = static_cast<uint8_t>(left);
  }
}

std::vector<uint8_t> decode_alpha(const uint8_t* p, size_t n, int width, int height) {
  if (n < 1) fail(2, "an empty ALPH chunk");
  const int method = p[0] & 3, filter = (p[0] >> 2) & 3;
  if (method > 1) fail(2, "an ALPH compression method out of range");
  const size_t total = static_cast<size_t>(width) * height;
  std::vector<uint8_t> raw(total);
  if (method == 0) {
    if (n - 1 < total) fail(2, "truncated ALPH data");
    std::memcpy(raw.data(), p + 1, total);
  } else {
    Lossless d{LBits{p + 1, n - 1}};
    std::vector<uint32_t> argb = d.image(width, height, true);
    for (size_t i = 0; i < total; ++i) raw[i] = static_cast<uint8_t>((argb[i] >> 8) & 255);
  }
  std::vector<uint8_t> out(total);
  for (int y = 0; y < height; ++y)
    unfilter_row(filter, y ? out.data() + static_cast<size_t>(y - 1) * width : nullptr,
                 raw.data() + static_cast<size_t>(y) * width, out.data() + static_cast<size_t>(y) * width, width);
  return out;
}

// ---- the container --------------------------------------------------------

struct Chunk {
  char fourcc[5] = {0};
  const uint8_t* data = nullptr;
  size_t size = 0;
};

std::vector<Chunk> chunks(const uint8_t* p, size_t n) {
  std::vector<Chunk> out;
  size_t pos = 0;
  while (pos + 8 <= n) {
    Chunk c;
    std::memcpy(c.fourcc, p + pos, 4);
    c.size = p[pos + 4] | (p[pos + 5] << 8) | (p[pos + 6] << 16) | (static_cast<size_t>(p[pos + 7]) << 24);
    c.data = p + pos + 8;
    if (pos + 8 + c.size > n) fail(2, std::string("a truncated ") + c.fourcc + " chunk");
    out.push_back(c);
    pos += 8 + c.size + (c.size & 1);
  }
  return out;
}

inline uint32_t u24(const uint8_t* p) { return p[0] | (p[1] << 8) | (static_cast<uint32_t>(p[2]) << 16); }

struct Image {
  int canvas_w = 0, canvas_h = 0;
  bool alpha = false;
  int fx = 0, fy = 0;
  const Chunk* alph = nullptr;
  const Chunk* bitstream = nullptr;
  std::vector<Chunk> all, frame;
};

void locate(const uint8_t* data, size_t size, Image& im) {
  if (size < 12 || std::memcmp(data, "RIFF", 4) != 0 || std::memcmp(data + 8, "WEBP", 4) != 0)
    fail(2, "not a WebP file");
  const size_t riff = data[4] | (data[5] << 8) | (data[6] << 16) | (static_cast<size_t>(data[7]) << 24);
  const size_t end = riff + 8 < size ? riff + 8 : size;
  im.all = chunks(data + 12, end - 12);
  if (im.all.empty()) fail(2, "a WebP file with no chunks");
  const Chunk& first = im.all[0];
  auto dims = [](const Chunk& c, int* w, int* h, bool* alpha) {
    if (!std::strcmp(c.fourcc, "VP8 ")) {
      if (c.size < 10) fail(2, "truncated VP8 frame header");
      *w = (c.data[6] | (c.data[7] << 8)) & 0x3fff;
      *h = (c.data[8] | (c.data[9] << 8)) & 0x3fff;
      *alpha = false;
    } else {
      if (c.size < 5 || c.data[0] != 0x2f) fail(2, "not a VP8L stream");
      const uint32_t bits = c.data[1] | (c.data[2] << 8) | (c.data[3] << 16) | (static_cast<uint32_t>(c.data[4]) << 24);
      *w = static_cast<int>(bits & 0x3fff) + 1;
      *h = static_cast<int>((bits >> 14) & 0x3fff) + 1;
      *alpha = (bits >> 28) & 1;
    }
  };
  if (!std::strcmp(first.fourcc, "VP8 ") || !std::strcmp(first.fourcc, "VP8L")) {
    int w, h;
    bool a;
    dims(first, &w, &h, &a);
    im.canvas_w = w;
    im.canvas_h = h;
    im.alpha = a;
    im.bitstream = &im.all[0];
    return;
  }
  if (std::strcmp(first.fourcc, "VP8X") || first.size < 10) fail(2, "a WebP file without an image chunk");
  const int flags = first.data[0];
  im.alpha = flags & 0x10;
  im.canvas_w = static_cast<int>(u24(first.data + 4)) + 1;
  im.canvas_h = static_cast<int>(u24(first.data + 7)) + 1;
  const std::vector<Chunk>* list = &im.all;
  if (flags & 0x02) {  // animation: the first ANMF frame
    const Chunk* anmf = nullptr;
    for (const Chunk& c : im.all)
      if (!std::strcmp(c.fourcc, "ANMF")) {
        anmf = &c;
        break;
      }
    if (!anmf || anmf->size < 16) fail(2, "an animated WebP file without a frame");
    im.fx = 2 * static_cast<int>(u24(anmf->data));
    im.fy = 2 * static_cast<int>(u24(anmf->data + 3));
    im.frame = chunks(anmf->data + 16, anmf->size - 16);
    list = &im.frame;
  }
  for (const Chunk& c : *list) {
    if (!std::strcmp(c.fourcc, "ALPH") && !im.alph) im.alph = &c;
    if (!std::strcmp(c.fourcc, "VP8 ") || !std::strcmp(c.fourcc, "VP8L")) {
      im.bitstream = &c;
      break;
    }
  }
  if (!im.bitstream) fail(2, "a WebP file without an image chunk");
  int w, h;
  bool a;
  dims(*im.bitstream, &w, &h, &a);
  if (im.fx + w > im.canvas_w || im.fy + h > im.canvas_h) fail(2, "a WebP frame outside its canvas");
}

// the frame as RGBA (straight alpha) rows
std::vector<uint8_t> decode_frame(const Image& im, int* width, int* height) {
  const Chunk& c = *im.bitstream;
  std::vector<uint8_t> rgba;
  if (!std::strcmp(c.fourcc, "VP8L")) {
    bool a;
    std::vector<uint32_t> argb = decode_vp8l(c.data, c.size, width, height, &a);
    rgba.resize(argb.size() * 4);
    for (size_t i = 0; i < argb.size(); ++i) {
      rgba[4 * i + 0] = static_cast<uint8_t>(argb[i] >> 16);
      rgba[4 * i + 1] = static_cast<uint8_t>(argb[i] >> 8);
      rgba[4 * i + 2] = static_cast<uint8_t>(argb[i]);
      rgba[4 * i + 3] = static_cast<uint8_t>(argb[i] >> 24);
    }
    return rgba;
  }
  Lossy d;
  d.header(c.data, c.size);
  d.decode();
  *width = d.width;
  *height = d.height;
  rgba.assign(static_cast<size_t>(d.width) * d.height * 4, 255);
  d.emit(rgba.data(), 4);
  if (im.alph) {
    std::vector<uint8_t> a = decode_alpha(im.alph->data, im.alph->size, d.width, d.height);
    for (size_t i = 0; i < a.size(); ++i) rgba[4 * i + 3] = a[i];
  }
  return rgba;
}

void set_error(char* err, int err_size, const std::string& msg) {
  if (err && err_size > 0) std::snprintf(err, static_cast<size_t>(err_size), "%s", msg.c_str());
}

}  // namespace

extern "C" int webp_decoder_abi_version() { return 1; }

extern "C" int webp_decode(const uint8_t* data, size_t size, uint8_t* out, size_t out_size, int* dims, char* err,
                           int err_size) {
  try {
    Image im;
    locate(data, size, im);
    const int channels = im.alpha ? 4 : 3;
    dims[0] = im.canvas_h;
    dims[1] = im.canvas_w;
    dims[2] = channels;
    if (out == nullptr) return 0;
    const size_t need = static_cast<size_t>(im.canvas_w) * im.canvas_h * channels;
    if (out_size < need) fail(2, "output buffer too small");
    int w = 0, h = 0;
    std::vector<uint8_t> frame = decode_frame(im, &w, &h);
    // the animation decoder's key frame: a transparent black canvas, the frame at its offset
    std::memset(out, 0, need);
    for (int y = 0; y < h; ++y)
      for (int x = 0; x < w; ++x) {
        const uint8_t* s = frame.data() + (static_cast<size_t>(y) * w + x) * 4;
        uint8_t* d = out + (static_cast<size_t>(y + im.fy) * im.canvas_w + x + im.fx) * channels;
        std::memcpy(d, s, channels);
      }
    return 0;
  } catch (const Error& e) {
    set_error(err, err_size, e.msg);
    return e.code;
  } catch (const std::exception& e) {
    set_error(err, err_size, e.what());
    return 2;
  }
}
