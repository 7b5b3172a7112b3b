/*!
 * C predict ABI — deployment-only interface, mirroring the reference's
 * include/mxnet/c_predict_api.h (create from symbol JSON + param bytes,
 * set input, forward, fetch outputs; no autodiff, no training machinery).
 *
 * The implementation (c_predict_api.cc) embeds CPython and delegates to
 * mxnet_tpu_torch.c_predict — the inverse layering of the reference (where
 * Python wraps C), because here the compute path is torch and the port's kernels
 * reached through Python. Link with libmxnet_tpu_torch_predict.so.
 *
 * All functions return 0 on success, -1 on failure;
 * MXTPredGetLastError() returns the failure message (thread-local).
 */
#ifndef MXNET_TPU_TORCH_C_PREDICT_API_H_
#define MXNET_TPU_TORCH_C_PREDICT_API_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef uint32_t mx_uint;
typedef float mx_float;
typedef void *PredictorHandle;

/*! \brief last error message of this thread (reference MXGetLastError) */
const char *MXTPredGetLastError(void);

/*!
 * \brief create a predictor (reference MXPredCreate, c_predict_api.h:41-63)
 * \param symbol_json_str symbol JSON text
 * \param param_bytes .params file contents
 * \param param_size byte length of param_bytes
 * \param dev_type 1=cpu, 2=gpu (cuda:dev_id)
 * \param dev_id device ordinal
 * \param num_input_nodes number of bound inputs
 * \param input_keys input names, e.g. {"data"}
 * \param input_shape_indptr CSR offsets into input_shape_data,
 *        length num_input_nodes+1
 * \param input_shape_data concatenated input shapes
 * \param out the created predictor handle
 */
int MXTPredCreate(const char *symbol_json_str,
                  const void *param_bytes,
                  int param_size,
                  int dev_type, int dev_id,
                  mx_uint num_input_nodes,
                  const char **input_keys,
                  const mx_uint *input_shape_indptr,
                  const mx_uint *input_shape_data,
                  PredictorHandle *out);

/*!
 * \brief create a predictor re-headed at internal outputs (reference
 * MXPredCreatePartialOut) — feature extraction from intermediate
 * layers. output_keys accept node names ("fc1") or explicit output
 * names ("fc1_output").
 */
int MXTPredCreatePartialOut(const char *symbol_json_str,
                            const void *param_bytes,
                            int param_size,
                            int dev_type, int dev_id,
                            mx_uint num_input_nodes,
                            const char **input_keys,
                            const mx_uint *input_shape_indptr,
                            const mx_uint *input_shape_data,
                            mx_uint num_output_nodes,
                            const char **output_keys,
                            PredictorHandle *out);

/*! \brief stage a float32 input by name (reference MXPredSetInput) */
int MXTPredSetInput(PredictorHandle handle,
                    const char *key,
                    const mx_float *data,
                    mx_uint size);

/*! \brief run the graph on staged inputs (reference MXPredForward) */
int MXTPredForward(PredictorHandle handle);

/*! \brief number of graph outputs */
int MXTPredNumOutputs(PredictorHandle handle, mx_uint *out);

/*!
 * \brief output shape (reference MXPredGetOutputShape); *shape_data is
 * valid until the next call on this handle
 */
int MXTPredGetOutputShape(PredictorHandle handle,
                          mx_uint index,
                          mx_uint **shape_data,
                          mx_uint *shape_ndim);

/*! \brief copy output into caller buffer (reference MXPredGetOutput) */
int MXTPredGetOutput(PredictorHandle handle,
                     mx_uint index,
                     mx_float *data,
                     mx_uint size);

/*! \brief free the predictor (reference MXPredFree) */
int MXTPredFree(PredictorHandle handle);

#ifdef __cplusplus
}
#endif

#endif  /* MXNET_TPU_TORCH_C_PREDICT_API_H_ */
