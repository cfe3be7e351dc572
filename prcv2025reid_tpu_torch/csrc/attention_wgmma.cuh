// wgmma forms of the attention kernel's register-held tiles
// (attention.cu::attn_reg_kernel), beside hopper.cuh's: QK^T at the key
// widths a consumer warpgroup holds (N = 136 .. 216, each accumulator range
// starting at a compile-time offset OFF of one score array; FIRST, the first
// k step, takes scale-d 0 and declares the range written only, so that the
// compiler keeps no earlier scores alive for it), and PV with A (the bf16
// probabilities) from registers.  The instruction names every accumulator
// register, so each width is written out.
//
// A from registers (m64nNk16, bf16): warp w of the warpgroup supplies rows
// 16 w .. 16 w + 15 as mma.sync m16n8k16 does (common.cuh): a0 = (g, 2t..+1),
// a1 = (g + 8, 2t..+1), a2 = (g, 2t + 8..+9), a3 = (g + 8, 2t + 8..+9); the
// f32 accumulator of an earlier m64nN product, columns 16 j .. 16 j + 15,
// is that operand for k step j: pack(d[8j], d[8j+1]), pack(d[8j+2], d[8j+3]),
// pack(d[8j+4], d[8j+5]), pack(d[8j+6], d[8j+7]).  The registers are read
// asynchronously: a wgmma.fence comes between their last write and the
// instruction, and they stay untouched until its wgmma.wait_group.
#pragma once

#include <stdint.h>

namespace hopper {

// d[OFF .. OFF + 67] (+)= A (64 x 16, smem desc) * B (16 x 136, smem desc), both K-major
template <int OFF, bool FIRST, int R>
__device__ __forceinline__ void wgmma_m64n136k16(float (&d)[R], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  static_assert(OFF + 68 <= R, "accumulator range");
  if constexpr (FIRST) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %70, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n136k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67"
        "}, %68, %69, p, 1, 1, 0, 0;\n}\n"
        :
          "=f"(d[OFF + 0]), "=f"(d[OFF + 1]), "=f"(d[OFF + 2]), "=f"(d[OFF + 3]), "=f"(d[OFF + 4]), "=f"(d[OFF + 5]), "=f"(d[OFF + 6]), "=f"(d[OFF + 7]),
          "=f"(d[OFF + 8]), "=f"(d[OFF + 9]), "=f"(d[OFF + 10]), "=f"(d[OFF + 11]), "=f"(d[OFF + 12]), "=f"(d[OFF + 13]), "=f"(d[OFF + 14]), "=f"(d[OFF + 15]),
          "=f"(d[OFF + 16]), "=f"(d[OFF + 17]), "=f"(d[OFF + 18]), "=f"(d[OFF + 19]), "=f"(d[OFF + 20]), "=f"(d[OFF + 21]), "=f"(d[OFF + 22]), "=f"(d[OFF + 23]),
          "=f"(d[OFF + 24]), "=f"(d[OFF + 25]), "=f"(d[OFF + 26]), "=f"(d[OFF + 27]), "=f"(d[OFF + 28]), "=f"(d[OFF + 29]), "=f"(d[OFF + 30]), "=f"(d[OFF + 31]),
          "=f"(d[OFF + 32]), "=f"(d[OFF + 33]), "=f"(d[OFF + 34]), "=f"(d[OFF + 35]), "=f"(d[OFF + 36]), "=f"(d[OFF + 37]), "=f"(d[OFF + 38]), "=f"(d[OFF + 39]),
          "=f"(d[OFF + 40]), "=f"(d[OFF + 41]), "=f"(d[OFF + 42]), "=f"(d[OFF + 43]), "=f"(d[OFF + 44]), "=f"(d[OFF + 45]), "=f"(d[OFF + 46]), "=f"(d[OFF + 47]),
          "=f"(d[OFF + 48]), "=f"(d[OFF + 49]), "=f"(d[OFF + 50]), "=f"(d[OFF + 51]), "=f"(d[OFF + 52]), "=f"(d[OFF + 53]), "=f"(d[OFF + 54]), "=f"(d[OFF + 55]),
          "=f"(d[OFF + 56]), "=f"(d[OFF + 57]), "=f"(d[OFF + 58]), "=f"(d[OFF + 59]), "=f"(d[OFF + 60]), "=f"(d[OFF + 61]), "=f"(d[OFF + 62]), "=f"(d[OFF + 63]),
          "=f"(d[OFF + 64]), "=f"(d[OFF + 65]), "=f"(d[OFF + 66]), "=f"(d[OFF + 67])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %70, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n136k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67"
        "}, %68, %69, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
          "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]), "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]),
          "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
          "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31]),
          "+f"(d[OFF + 32]), "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]), "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]), "+f"(d[OFF + 39]),
          "+f"(d[OFF + 40]), "+f"(d[OFF + 41]), "+f"(d[OFF + 42]), "+f"(d[OFF + 43]), "+f"(d[OFF + 44]), "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]),
          "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]), "+f"(d[OFF + 51]), "+f"(d[OFF + 52]), "+f"(d[OFF + 53]), "+f"(d[OFF + 54]), "+f"(d[OFF + 55]),
          "+f"(d[OFF + 56]), "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]), "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]), "+f"(d[OFF + 63]),
          "+f"(d[OFF + 64]), "+f"(d[OFF + 65]), "+f"(d[OFF + 66]), "+f"(d[OFF + 67])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
}

// d[OFF .. OFF + 71] (+)= A (64 x 16, smem desc) * B (16 x 144, smem desc), both K-major
template <int OFF, bool FIRST, int R>
__device__ __forceinline__ void wgmma_m64n144k16(float (&d)[R], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  static_assert(OFF + 72 <= R, "accumulator range");
  if constexpr (FIRST) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %74, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71"
        "}, %72, %73, p, 1, 1, 0, 0;\n}\n"
        :
          "=f"(d[OFF + 0]), "=f"(d[OFF + 1]), "=f"(d[OFF + 2]), "=f"(d[OFF + 3]), "=f"(d[OFF + 4]), "=f"(d[OFF + 5]), "=f"(d[OFF + 6]), "=f"(d[OFF + 7]),
          "=f"(d[OFF + 8]), "=f"(d[OFF + 9]), "=f"(d[OFF + 10]), "=f"(d[OFF + 11]), "=f"(d[OFF + 12]), "=f"(d[OFF + 13]), "=f"(d[OFF + 14]), "=f"(d[OFF + 15]),
          "=f"(d[OFF + 16]), "=f"(d[OFF + 17]), "=f"(d[OFF + 18]), "=f"(d[OFF + 19]), "=f"(d[OFF + 20]), "=f"(d[OFF + 21]), "=f"(d[OFF + 22]), "=f"(d[OFF + 23]),
          "=f"(d[OFF + 24]), "=f"(d[OFF + 25]), "=f"(d[OFF + 26]), "=f"(d[OFF + 27]), "=f"(d[OFF + 28]), "=f"(d[OFF + 29]), "=f"(d[OFF + 30]), "=f"(d[OFF + 31]),
          "=f"(d[OFF + 32]), "=f"(d[OFF + 33]), "=f"(d[OFF + 34]), "=f"(d[OFF + 35]), "=f"(d[OFF + 36]), "=f"(d[OFF + 37]), "=f"(d[OFF + 38]), "=f"(d[OFF + 39]),
          "=f"(d[OFF + 40]), "=f"(d[OFF + 41]), "=f"(d[OFF + 42]), "=f"(d[OFF + 43]), "=f"(d[OFF + 44]), "=f"(d[OFF + 45]), "=f"(d[OFF + 46]), "=f"(d[OFF + 47]),
          "=f"(d[OFF + 48]), "=f"(d[OFF + 49]), "=f"(d[OFF + 50]), "=f"(d[OFF + 51]), "=f"(d[OFF + 52]), "=f"(d[OFF + 53]), "=f"(d[OFF + 54]), "=f"(d[OFF + 55]),
          "=f"(d[OFF + 56]), "=f"(d[OFF + 57]), "=f"(d[OFF + 58]), "=f"(d[OFF + 59]), "=f"(d[OFF + 60]), "=f"(d[OFF + 61]), "=f"(d[OFF + 62]), "=f"(d[OFF + 63]),
          "=f"(d[OFF + 64]), "=f"(d[OFF + 65]), "=f"(d[OFF + 66]), "=f"(d[OFF + 67]), "=f"(d[OFF + 68]), "=f"(d[OFF + 69]), "=f"(d[OFF + 70]), "=f"(d[OFF + 71])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %74, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n144k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71"
        "}, %72, %73, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
          "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]), "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]),
          "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
          "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31]),
          "+f"(d[OFF + 32]), "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]), "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]), "+f"(d[OFF + 39]),
          "+f"(d[OFF + 40]), "+f"(d[OFF + 41]), "+f"(d[OFF + 42]), "+f"(d[OFF + 43]), "+f"(d[OFF + 44]), "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]),
          "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]), "+f"(d[OFF + 51]), "+f"(d[OFF + 52]), "+f"(d[OFF + 53]), "+f"(d[OFF + 54]), "+f"(d[OFF + 55]),
          "+f"(d[OFF + 56]), "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]), "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]), "+f"(d[OFF + 63]),
          "+f"(d[OFF + 64]), "+f"(d[OFF + 65]), "+f"(d[OFF + 66]), "+f"(d[OFF + 67]), "+f"(d[OFF + 68]), "+f"(d[OFF + 69]), "+f"(d[OFF + 70]), "+f"(d[OFF + 71])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
}

// d[OFF .. OFF + 75] (+)= A (64 x 16, smem desc) * B (16 x 152, smem desc), both K-major
template <int OFF, bool FIRST, int R>
__device__ __forceinline__ void wgmma_m64n152k16(float (&d)[R], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  static_assert(OFF + 76 <= R, "accumulator range");
  if constexpr (FIRST) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %78, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n152k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75"
        "}, %76, %77, p, 1, 1, 0, 0;\n}\n"
        :
          "=f"(d[OFF + 0]), "=f"(d[OFF + 1]), "=f"(d[OFF + 2]), "=f"(d[OFF + 3]), "=f"(d[OFF + 4]), "=f"(d[OFF + 5]), "=f"(d[OFF + 6]), "=f"(d[OFF + 7]),
          "=f"(d[OFF + 8]), "=f"(d[OFF + 9]), "=f"(d[OFF + 10]), "=f"(d[OFF + 11]), "=f"(d[OFF + 12]), "=f"(d[OFF + 13]), "=f"(d[OFF + 14]), "=f"(d[OFF + 15]),
          "=f"(d[OFF + 16]), "=f"(d[OFF + 17]), "=f"(d[OFF + 18]), "=f"(d[OFF + 19]), "=f"(d[OFF + 20]), "=f"(d[OFF + 21]), "=f"(d[OFF + 22]), "=f"(d[OFF + 23]),
          "=f"(d[OFF + 24]), "=f"(d[OFF + 25]), "=f"(d[OFF + 26]), "=f"(d[OFF + 27]), "=f"(d[OFF + 28]), "=f"(d[OFF + 29]), "=f"(d[OFF + 30]), "=f"(d[OFF + 31]),
          "=f"(d[OFF + 32]), "=f"(d[OFF + 33]), "=f"(d[OFF + 34]), "=f"(d[OFF + 35]), "=f"(d[OFF + 36]), "=f"(d[OFF + 37]), "=f"(d[OFF + 38]), "=f"(d[OFF + 39]),
          "=f"(d[OFF + 40]), "=f"(d[OFF + 41]), "=f"(d[OFF + 42]), "=f"(d[OFF + 43]), "=f"(d[OFF + 44]), "=f"(d[OFF + 45]), "=f"(d[OFF + 46]), "=f"(d[OFF + 47]),
          "=f"(d[OFF + 48]), "=f"(d[OFF + 49]), "=f"(d[OFF + 50]), "=f"(d[OFF + 51]), "=f"(d[OFF + 52]), "=f"(d[OFF + 53]), "=f"(d[OFF + 54]), "=f"(d[OFF + 55]),
          "=f"(d[OFF + 56]), "=f"(d[OFF + 57]), "=f"(d[OFF + 58]), "=f"(d[OFF + 59]), "=f"(d[OFF + 60]), "=f"(d[OFF + 61]), "=f"(d[OFF + 62]), "=f"(d[OFF + 63]),
          "=f"(d[OFF + 64]), "=f"(d[OFF + 65]), "=f"(d[OFF + 66]), "=f"(d[OFF + 67]), "=f"(d[OFF + 68]), "=f"(d[OFF + 69]), "=f"(d[OFF + 70]), "=f"(d[OFF + 71]),
          "=f"(d[OFF + 72]), "=f"(d[OFF + 73]), "=f"(d[OFF + 74]), "=f"(d[OFF + 75])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %78, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n152k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75"
        "}, %76, %77, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
          "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]), "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]),
          "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
          "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31]),
          "+f"(d[OFF + 32]), "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]), "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]), "+f"(d[OFF + 39]),
          "+f"(d[OFF + 40]), "+f"(d[OFF + 41]), "+f"(d[OFF + 42]), "+f"(d[OFF + 43]), "+f"(d[OFF + 44]), "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]),
          "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]), "+f"(d[OFF + 51]), "+f"(d[OFF + 52]), "+f"(d[OFF + 53]), "+f"(d[OFF + 54]), "+f"(d[OFF + 55]),
          "+f"(d[OFF + 56]), "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]), "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]), "+f"(d[OFF + 63]),
          "+f"(d[OFF + 64]), "+f"(d[OFF + 65]), "+f"(d[OFF + 66]), "+f"(d[OFF + 67]), "+f"(d[OFF + 68]), "+f"(d[OFF + 69]), "+f"(d[OFF + 70]), "+f"(d[OFF + 71]),
          "+f"(d[OFF + 72]), "+f"(d[OFF + 73]), "+f"(d[OFF + 74]), "+f"(d[OFF + 75])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
}

// d[OFF .. OFF + 79] (+)= A (64 x 16, smem desc) * B (16 x 160, smem desc), both K-major
template <int OFF, bool FIRST, int R>
__device__ __forceinline__ void wgmma_m64n160k16(float (&d)[R], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  static_assert(OFF + 80 <= R, "accumulator range");
  if constexpr (FIRST) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %82, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
        "}, %80, %81, p, 1, 1, 0, 0;\n}\n"
        :
          "=f"(d[OFF + 0]), "=f"(d[OFF + 1]), "=f"(d[OFF + 2]), "=f"(d[OFF + 3]), "=f"(d[OFF + 4]), "=f"(d[OFF + 5]), "=f"(d[OFF + 6]), "=f"(d[OFF + 7]),
          "=f"(d[OFF + 8]), "=f"(d[OFF + 9]), "=f"(d[OFF + 10]), "=f"(d[OFF + 11]), "=f"(d[OFF + 12]), "=f"(d[OFF + 13]), "=f"(d[OFF + 14]), "=f"(d[OFF + 15]),
          "=f"(d[OFF + 16]), "=f"(d[OFF + 17]), "=f"(d[OFF + 18]), "=f"(d[OFF + 19]), "=f"(d[OFF + 20]), "=f"(d[OFF + 21]), "=f"(d[OFF + 22]), "=f"(d[OFF + 23]),
          "=f"(d[OFF + 24]), "=f"(d[OFF + 25]), "=f"(d[OFF + 26]), "=f"(d[OFF + 27]), "=f"(d[OFF + 28]), "=f"(d[OFF + 29]), "=f"(d[OFF + 30]), "=f"(d[OFF + 31]),
          "=f"(d[OFF + 32]), "=f"(d[OFF + 33]), "=f"(d[OFF + 34]), "=f"(d[OFF + 35]), "=f"(d[OFF + 36]), "=f"(d[OFF + 37]), "=f"(d[OFF + 38]), "=f"(d[OFF + 39]),
          "=f"(d[OFF + 40]), "=f"(d[OFF + 41]), "=f"(d[OFF + 42]), "=f"(d[OFF + 43]), "=f"(d[OFF + 44]), "=f"(d[OFF + 45]), "=f"(d[OFF + 46]), "=f"(d[OFF + 47]),
          "=f"(d[OFF + 48]), "=f"(d[OFF + 49]), "=f"(d[OFF + 50]), "=f"(d[OFF + 51]), "=f"(d[OFF + 52]), "=f"(d[OFF + 53]), "=f"(d[OFF + 54]), "=f"(d[OFF + 55]),
          "=f"(d[OFF + 56]), "=f"(d[OFF + 57]), "=f"(d[OFF + 58]), "=f"(d[OFF + 59]), "=f"(d[OFF + 60]), "=f"(d[OFF + 61]), "=f"(d[OFF + 62]), "=f"(d[OFF + 63]),
          "=f"(d[OFF + 64]), "=f"(d[OFF + 65]), "=f"(d[OFF + 66]), "=f"(d[OFF + 67]), "=f"(d[OFF + 68]), "=f"(d[OFF + 69]), "=f"(d[OFF + 70]), "=f"(d[OFF + 71]),
          "=f"(d[OFF + 72]), "=f"(d[OFF + 73]), "=f"(d[OFF + 74]), "=f"(d[OFF + 75]), "=f"(d[OFF + 76]), "=f"(d[OFF + 77]), "=f"(d[OFF + 78]), "=f"(d[OFF + 79])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %82, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79"
        "}, %80, %81, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
          "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]), "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]),
          "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
          "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31]),
          "+f"(d[OFF + 32]), "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]), "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]), "+f"(d[OFF + 39]),
          "+f"(d[OFF + 40]), "+f"(d[OFF + 41]), "+f"(d[OFF + 42]), "+f"(d[OFF + 43]), "+f"(d[OFF + 44]), "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]),
          "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]), "+f"(d[OFF + 51]), "+f"(d[OFF + 52]), "+f"(d[OFF + 53]), "+f"(d[OFF + 54]), "+f"(d[OFF + 55]),
          "+f"(d[OFF + 56]), "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]), "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]), "+f"(d[OFF + 63]),
          "+f"(d[OFF + 64]), "+f"(d[OFF + 65]), "+f"(d[OFF + 66]), "+f"(d[OFF + 67]), "+f"(d[OFF + 68]), "+f"(d[OFF + 69]), "+f"(d[OFF + 70]), "+f"(d[OFF + 71]),
          "+f"(d[OFF + 72]), "+f"(d[OFF + 73]), "+f"(d[OFF + 74]), "+f"(d[OFF + 75]), "+f"(d[OFF + 76]), "+f"(d[OFF + 77]), "+f"(d[OFF + 78]), "+f"(d[OFF + 79])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
}

// d[OFF .. OFF + 83] (+)= A (64 x 16, smem desc) * B (16 x 168, smem desc), both K-major
template <int OFF, bool FIRST, int R>
__device__ __forceinline__ void wgmma_m64n168k16(float (&d)[R], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  static_assert(OFF + 84 <= R, "accumulator range");
  if constexpr (FIRST) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %86, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n168k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83"
        "}, %84, %85, p, 1, 1, 0, 0;\n}\n"
        :
          "=f"(d[OFF + 0]), "=f"(d[OFF + 1]), "=f"(d[OFF + 2]), "=f"(d[OFF + 3]), "=f"(d[OFF + 4]), "=f"(d[OFF + 5]), "=f"(d[OFF + 6]), "=f"(d[OFF + 7]),
          "=f"(d[OFF + 8]), "=f"(d[OFF + 9]), "=f"(d[OFF + 10]), "=f"(d[OFF + 11]), "=f"(d[OFF + 12]), "=f"(d[OFF + 13]), "=f"(d[OFF + 14]), "=f"(d[OFF + 15]),
          "=f"(d[OFF + 16]), "=f"(d[OFF + 17]), "=f"(d[OFF + 18]), "=f"(d[OFF + 19]), "=f"(d[OFF + 20]), "=f"(d[OFF + 21]), "=f"(d[OFF + 22]), "=f"(d[OFF + 23]),
          "=f"(d[OFF + 24]), "=f"(d[OFF + 25]), "=f"(d[OFF + 26]), "=f"(d[OFF + 27]), "=f"(d[OFF + 28]), "=f"(d[OFF + 29]), "=f"(d[OFF + 30]), "=f"(d[OFF + 31]),
          "=f"(d[OFF + 32]), "=f"(d[OFF + 33]), "=f"(d[OFF + 34]), "=f"(d[OFF + 35]), "=f"(d[OFF + 36]), "=f"(d[OFF + 37]), "=f"(d[OFF + 38]), "=f"(d[OFF + 39]),
          "=f"(d[OFF + 40]), "=f"(d[OFF + 41]), "=f"(d[OFF + 42]), "=f"(d[OFF + 43]), "=f"(d[OFF + 44]), "=f"(d[OFF + 45]), "=f"(d[OFF + 46]), "=f"(d[OFF + 47]),
          "=f"(d[OFF + 48]), "=f"(d[OFF + 49]), "=f"(d[OFF + 50]), "=f"(d[OFF + 51]), "=f"(d[OFF + 52]), "=f"(d[OFF + 53]), "=f"(d[OFF + 54]), "=f"(d[OFF + 55]),
          "=f"(d[OFF + 56]), "=f"(d[OFF + 57]), "=f"(d[OFF + 58]), "=f"(d[OFF + 59]), "=f"(d[OFF + 60]), "=f"(d[OFF + 61]), "=f"(d[OFF + 62]), "=f"(d[OFF + 63]),
          "=f"(d[OFF + 64]), "=f"(d[OFF + 65]), "=f"(d[OFF + 66]), "=f"(d[OFF + 67]), "=f"(d[OFF + 68]), "=f"(d[OFF + 69]), "=f"(d[OFF + 70]), "=f"(d[OFF + 71]),
          "=f"(d[OFF + 72]), "=f"(d[OFF + 73]), "=f"(d[OFF + 74]), "=f"(d[OFF + 75]), "=f"(d[OFF + 76]), "=f"(d[OFF + 77]), "=f"(d[OFF + 78]), "=f"(d[OFF + 79]),
          "=f"(d[OFF + 80]), "=f"(d[OFF + 81]), "=f"(d[OFF + 82]), "=f"(d[OFF + 83])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %86, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n168k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83"
        "}, %84, %85, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
          "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]), "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]),
          "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
          "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31]),
          "+f"(d[OFF + 32]), "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]), "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]), "+f"(d[OFF + 39]),
          "+f"(d[OFF + 40]), "+f"(d[OFF + 41]), "+f"(d[OFF + 42]), "+f"(d[OFF + 43]), "+f"(d[OFF + 44]), "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]),
          "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]), "+f"(d[OFF + 51]), "+f"(d[OFF + 52]), "+f"(d[OFF + 53]), "+f"(d[OFF + 54]), "+f"(d[OFF + 55]),
          "+f"(d[OFF + 56]), "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]), "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]), "+f"(d[OFF + 63]),
          "+f"(d[OFF + 64]), "+f"(d[OFF + 65]), "+f"(d[OFF + 66]), "+f"(d[OFF + 67]), "+f"(d[OFF + 68]), "+f"(d[OFF + 69]), "+f"(d[OFF + 70]), "+f"(d[OFF + 71]),
          "+f"(d[OFF + 72]), "+f"(d[OFF + 73]), "+f"(d[OFF + 74]), "+f"(d[OFF + 75]), "+f"(d[OFF + 76]), "+f"(d[OFF + 77]), "+f"(d[OFF + 78]), "+f"(d[OFF + 79]),
          "+f"(d[OFF + 80]), "+f"(d[OFF + 81]), "+f"(d[OFF + 82]), "+f"(d[OFF + 83])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
}

// d[OFF .. OFF + 107] (+)= A (64 x 16, smem desc) * B (16 x 216, smem desc), both K-major
template <int OFF, bool FIRST, int R>
__device__ __forceinline__ void wgmma_m64n216k16(float (&d)[R], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  static_assert(OFF + 108 <= R, "accumulator range");
  if constexpr (FIRST) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %110, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n216k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107"
        "}, %108, %109, p, 1, 1, 0, 0;\n}\n"
        :
          "=f"(d[OFF + 0]), "=f"(d[OFF + 1]), "=f"(d[OFF + 2]), "=f"(d[OFF + 3]), "=f"(d[OFF + 4]), "=f"(d[OFF + 5]), "=f"(d[OFF + 6]), "=f"(d[OFF + 7]),
          "=f"(d[OFF + 8]), "=f"(d[OFF + 9]), "=f"(d[OFF + 10]), "=f"(d[OFF + 11]), "=f"(d[OFF + 12]), "=f"(d[OFF + 13]), "=f"(d[OFF + 14]), "=f"(d[OFF + 15]),
          "=f"(d[OFF + 16]), "=f"(d[OFF + 17]), "=f"(d[OFF + 18]), "=f"(d[OFF + 19]), "=f"(d[OFF + 20]), "=f"(d[OFF + 21]), "=f"(d[OFF + 22]), "=f"(d[OFF + 23]),
          "=f"(d[OFF + 24]), "=f"(d[OFF + 25]), "=f"(d[OFF + 26]), "=f"(d[OFF + 27]), "=f"(d[OFF + 28]), "=f"(d[OFF + 29]), "=f"(d[OFF + 30]), "=f"(d[OFF + 31]),
          "=f"(d[OFF + 32]), "=f"(d[OFF + 33]), "=f"(d[OFF + 34]), "=f"(d[OFF + 35]), "=f"(d[OFF + 36]), "=f"(d[OFF + 37]), "=f"(d[OFF + 38]), "=f"(d[OFF + 39]),
          "=f"(d[OFF + 40]), "=f"(d[OFF + 41]), "=f"(d[OFF + 42]), "=f"(d[OFF + 43]), "=f"(d[OFF + 44]), "=f"(d[OFF + 45]), "=f"(d[OFF + 46]), "=f"(d[OFF + 47]),
          "=f"(d[OFF + 48]), "=f"(d[OFF + 49]), "=f"(d[OFF + 50]), "=f"(d[OFF + 51]), "=f"(d[OFF + 52]), "=f"(d[OFF + 53]), "=f"(d[OFF + 54]), "=f"(d[OFF + 55]),
          "=f"(d[OFF + 56]), "=f"(d[OFF + 57]), "=f"(d[OFF + 58]), "=f"(d[OFF + 59]), "=f"(d[OFF + 60]), "=f"(d[OFF + 61]), "=f"(d[OFF + 62]), "=f"(d[OFF + 63]),
          "=f"(d[OFF + 64]), "=f"(d[OFF + 65]), "=f"(d[OFF + 66]), "=f"(d[OFF + 67]), "=f"(d[OFF + 68]), "=f"(d[OFF + 69]), "=f"(d[OFF + 70]), "=f"(d[OFF + 71]),
          "=f"(d[OFF + 72]), "=f"(d[OFF + 73]), "=f"(d[OFF + 74]), "=f"(d[OFF + 75]), "=f"(d[OFF + 76]), "=f"(d[OFF + 77]), "=f"(d[OFF + 78]), "=f"(d[OFF + 79]),
          "=f"(d[OFF + 80]), "=f"(d[OFF + 81]), "=f"(d[OFF + 82]), "=f"(d[OFF + 83]), "=f"(d[OFF + 84]), "=f"(d[OFF + 85]), "=f"(d[OFF + 86]), "=f"(d[OFF + 87]),
          "=f"(d[OFF + 88]), "=f"(d[OFF + 89]), "=f"(d[OFF + 90]), "=f"(d[OFF + 91]), "=f"(d[OFF + 92]), "=f"(d[OFF + 93]), "=f"(d[OFF + 94]), "=f"(d[OFF + 95]),
          "=f"(d[OFF + 96]), "=f"(d[OFF + 97]), "=f"(d[OFF + 98]), "=f"(d[OFF + 99]), "=f"(d[OFF + 100]), "=f"(d[OFF + 101]), "=f"(d[OFF + 102]), "=f"(d[OFF + 103]),
          "=f"(d[OFF + 104]), "=f"(d[OFF + 105]), "=f"(d[OFF + 106]), "=f"(d[OFF + 107])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  } else {
    asm volatile(
        "{\n.reg .pred p;\n"
        "setp.ne.b32 p, %110, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n216k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63,"
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79,"
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95,"
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107"
        "}, %108, %109, p, 1, 1, 0, 0;\n}\n"
        :
          "+f"(d[OFF + 0]), "+f"(d[OFF + 1]), "+f"(d[OFF + 2]), "+f"(d[OFF + 3]), "+f"(d[OFF + 4]), "+f"(d[OFF + 5]), "+f"(d[OFF + 6]), "+f"(d[OFF + 7]),
          "+f"(d[OFF + 8]), "+f"(d[OFF + 9]), "+f"(d[OFF + 10]), "+f"(d[OFF + 11]), "+f"(d[OFF + 12]), "+f"(d[OFF + 13]), "+f"(d[OFF + 14]), "+f"(d[OFF + 15]),
          "+f"(d[OFF + 16]), "+f"(d[OFF + 17]), "+f"(d[OFF + 18]), "+f"(d[OFF + 19]), "+f"(d[OFF + 20]), "+f"(d[OFF + 21]), "+f"(d[OFF + 22]), "+f"(d[OFF + 23]),
          "+f"(d[OFF + 24]), "+f"(d[OFF + 25]), "+f"(d[OFF + 26]), "+f"(d[OFF + 27]), "+f"(d[OFF + 28]), "+f"(d[OFF + 29]), "+f"(d[OFF + 30]), "+f"(d[OFF + 31]),
          "+f"(d[OFF + 32]), "+f"(d[OFF + 33]), "+f"(d[OFF + 34]), "+f"(d[OFF + 35]), "+f"(d[OFF + 36]), "+f"(d[OFF + 37]), "+f"(d[OFF + 38]), "+f"(d[OFF + 39]),
          "+f"(d[OFF + 40]), "+f"(d[OFF + 41]), "+f"(d[OFF + 42]), "+f"(d[OFF + 43]), "+f"(d[OFF + 44]), "+f"(d[OFF + 45]), "+f"(d[OFF + 46]), "+f"(d[OFF + 47]),
          "+f"(d[OFF + 48]), "+f"(d[OFF + 49]), "+f"(d[OFF + 50]), "+f"(d[OFF + 51]), "+f"(d[OFF + 52]), "+f"(d[OFF + 53]), "+f"(d[OFF + 54]), "+f"(d[OFF + 55]),
          "+f"(d[OFF + 56]), "+f"(d[OFF + 57]), "+f"(d[OFF + 58]), "+f"(d[OFF + 59]), "+f"(d[OFF + 60]), "+f"(d[OFF + 61]), "+f"(d[OFF + 62]), "+f"(d[OFF + 63]),
          "+f"(d[OFF + 64]), "+f"(d[OFF + 65]), "+f"(d[OFF + 66]), "+f"(d[OFF + 67]), "+f"(d[OFF + 68]), "+f"(d[OFF + 69]), "+f"(d[OFF + 70]), "+f"(d[OFF + 71]),
          "+f"(d[OFF + 72]), "+f"(d[OFF + 73]), "+f"(d[OFF + 74]), "+f"(d[OFF + 75]), "+f"(d[OFF + 76]), "+f"(d[OFF + 77]), "+f"(d[OFF + 78]), "+f"(d[OFF + 79]),
          "+f"(d[OFF + 80]), "+f"(d[OFF + 81]), "+f"(d[OFF + 82]), "+f"(d[OFF + 83]), "+f"(d[OFF + 84]), "+f"(d[OFF + 85]), "+f"(d[OFF + 86]), "+f"(d[OFF + 87]),
          "+f"(d[OFF + 88]), "+f"(d[OFF + 89]), "+f"(d[OFF + 90]), "+f"(d[OFF + 91]), "+f"(d[OFF + 92]), "+f"(d[OFF + 93]), "+f"(d[OFF + 94]), "+f"(d[OFF + 95]),
          "+f"(d[OFF + 96]), "+f"(d[OFF + 97]), "+f"(d[OFF + 98]), "+f"(d[OFF + 99]), "+f"(d[OFF + 100]), "+f"(d[OFF + 101]), "+f"(d[OFF + 102]), "+f"(d[OFF + 103]),
          "+f"(d[OFF + 104]), "+f"(d[OFF + 105]), "+f"(d[OFF + 106]), "+f"(d[OFF + 107])
        : "l"(desc_a), "l"(desc_b), "r"(scale_d));
  }
}

// d[0..31] (+)= A (64 x 16 bf16, registers) * B (16 x 64, smem desc, MN-major: trans-b)
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t (&a)[4], uint64_t desc_b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

}  // namespace hopper
