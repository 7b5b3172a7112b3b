/* Minimal C deployment client for the native predict ABI — the analogue
 * of the reference's amalgamation/predict example and
 * tests/python/predict/mxnet_predict_example.py, but in plain C against
 * libmxnet_tpu_torch_predict.so.
 *
 * Usage: predict_example <symbol.json> <model.params> <dev_type> <dev_id>
 *        N C [H W]
 * dev_type 2 runs on cuda:dev_id, 1 on the host. Reads float32 input from
 * stdin (N*C[*H*W] little-endian floats), prints output[0] as text floats
 * (9 significant digits, so a float round-trips), then the milliseconds
 * of the second MXTPredForward (the first loads the kernels) on stderr.
 */
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>

#include "c_predict_api.h"

static char *read_file(const char *path, long *size) {
  FILE *f = fopen(path, "rb");
  if (!f) { fprintf(stderr, "cannot open %s\n", path); exit(1); }
  fseek(f, 0, SEEK_END);
  *size = ftell(f);
  fseek(f, 0, SEEK_SET);
  char *buf = (char *)malloc(*size + 1);
  if (fread(buf, 1, *size, f) != (size_t)*size) { exit(1); }
  buf[*size] = 0;
  fclose(f);
  return buf;
}

int main(int argc, char **argv) {
  if (argc < 7 || argc > 9) {
    fprintf(stderr,
            "usage: %s symbol.json model.params dev_type dev_id N C [H W]\n",
            argv[0]);
    return 2;
  }
  int dev_type = atoi(argv[3]), dev_id = atoi(argv[4]);
  long sym_size, param_size;
  char *sym_json = read_file(argv[1], &sym_size);
  char *params = read_file(argv[2], &param_size);

  mx_uint shape[4];
  mx_uint ndim = (mx_uint)(argc - 5);
  mx_uint total = 1;
  for (mx_uint i = 0; i < ndim; ++i) {
    shape[i] = (mx_uint)atoi(argv[5 + i]);
    total *= shape[i];
  }
  const char *keys[] = {"data"};
  mx_uint indptr[] = {0, ndim};

  PredictorHandle pred = NULL;
  if (MXTPredCreate(sym_json, params, (int)param_size, dev_type, dev_id, 1,
                    keys, indptr, shape, &pred) != 0) {
    fprintf(stderr, "create failed: %s\n", MXTPredGetLastError());
    return 1;
  }

  float *input = (float *)malloc(sizeof(float) * total);
  if (fread(input, sizeof(float), total, stdin) != total) {
    fprintf(stderr, "stdin: expected %u floats\n", total);
    return 1;
  }
  struct timespec t0, t1;
  if (MXTPredSetInput(pred, "data", input, total) != 0) {
    fprintf(stderr, "forward failed: %s\n", MXTPredGetLastError());
    return 1;
  }
  /* the second forward is timed: the first loads the kernels */
  for (int rep = 0; rep < 2; ++rep) {
    clock_gettime(CLOCK_MONOTONIC, &t0);
    if (MXTPredForward(pred) != 0) {
      fprintf(stderr, "forward failed: %s\n", MXTPredGetLastError());
      return 1;
    }
    clock_gettime(CLOCK_MONOTONIC, &t1);
  }

  mx_uint *oshape = NULL, ondim = 0;
  if (MXTPredGetOutputShape(pred, 0, &oshape, &ondim) != 0) {
    fprintf(stderr, "shape failed: %s\n", MXTPredGetLastError());
    return 1;
  }
  mx_uint osize = 1;
  for (mx_uint i = 0; i < ondim; ++i) osize *= oshape[i];
  float *out = (float *)malloc(sizeof(float) * osize);
  if (MXTPredGetOutput(pred, 0, out, osize) != 0) {
    fprintf(stderr, "output failed: %s\n", MXTPredGetLastError());
    return 1;
  }
  for (mx_uint i = 0; i < osize; ++i) printf("%.9g\n", out[i]);
  fprintf(stderr, "forward_ms %.3f\n", (t1.tv_sec - t0.tv_sec) * 1e3 +
                                            (t1.tv_nsec - t0.tv_nsec) * 1e-6);
  MXTPredFree(pred);
  free(out);
  free(input);
  free(sym_json);
  free(params);
  return 0;
}
