/*!
 * Full native C graph ABI for mxnet_tpu_torch — NDArray / function registry /
 * Symbol / Executor / DataIter / KVStore.
 *
 * Reference parity: include/mxnet/c_api.h (~95 MX* functions). Same
 * conventions: every function returns 0 on success, -1 on failure with
 * the message from MXTApiGetLastError() (thread-local); output pointer
 * arrays are backed by thread-local scratch valid until the next ABI call
 * on the same thread (the reference's MXAPIThreadLocalEntry ring buffer,
 * src/c_api/c_api.cc).
 *
 * Implementation embeds CPython (the compute path is Python over torch) and
 * marshals through mxnet_tpu_torch/c_api_impl.py; handles are opaque integer
 * ids, never PyObject pointers, so callers need no Python knowledge and
 * C function-pointer callbacks (MXTKVStoreSetUpdater) re-enter cleanly.
 */
#ifndef MXNET_TPU_TORCH_C_API_GRAPH_H_
#define MXNET_TPU_TORCH_C_API_GRAPH_H_

#ifdef __cplusplus
extern "C" {
#endif

#include <stddef.h>
#include <stdint.h>

typedef unsigned int mx_uint;
typedef float mx_float;
typedef void *NDArrayHandle;
typedef const void *FunctionHandle;
typedef void *AtomicSymbolCreator;
typedef void *SymbolHandle;
typedef void *ExecutorHandle;
typedef void *DataIterCreator;
typedef void *DataIterHandle;
typedef void *KVStoreHandle;

/*! updater callback for MXTKVStoreSetUpdater (reference c_api.h:1075) */
typedef void (MXTKVStoreUpdater)(int key, NDArrayHandle recv,
                                 NDArrayHandle local, void *handle);

/*! last error message on this thread */
const char *MXTApiGetLastError(void);

/* ---- global ---------------------------------------------------------- */
int MXTRandomSeed(int seed);
int MXTNotifyShutdown(void);

/* ---- NDArray --------------------------------------------------------- */
int MXTNDArrayCreateNone(NDArrayHandle *out);
int MXTNDArrayCreate(const mx_uint *shape, mx_uint ndim, int dev_type,
                     int dev_id, int delay_alloc, NDArrayHandle *out);
int MXTNDArrayCreateEx(const mx_uint *shape, mx_uint ndim, int dev_type,
                       int dev_id, int delay_alloc, int dtype,
                       NDArrayHandle *out);
int MXTNDArrayFree(NDArrayHandle handle);
int MXTNDArrayGetShape(NDArrayHandle handle, mx_uint *out_dim,
                       const mx_uint **out_pdata);
int MXTNDArrayGetDType(NDArrayHandle handle, int *out_dtype);
int MXTNDArrayGetContext(NDArrayHandle handle, int *out_dev_type,
                         int *out_dev_id);
/*! copy `size` elements of raw data into/out of the array */
int MXTNDArraySyncCopyFromCPU(NDArrayHandle handle, const void *data,
                              size_t size);
int MXTNDArraySyncCopyToCPU(NDArrayHandle handle, void *data, size_t size);
int MXTNDArrayWaitToRead(NDArrayHandle handle);
int MXTNDArrayWaitToWrite(NDArrayHandle handle);
int MXTNDArrayWaitAll(void);
int MXTNDArraySlice(NDArrayHandle handle, mx_uint slice_begin,
                    mx_uint slice_end, NDArrayHandle *out);
int MXTNDArrayReshape(NDArrayHandle handle, int ndim, const int *dims,
                      NDArrayHandle *out);
int MXTNDArraySave(const char *fname, mx_uint num_args,
                   NDArrayHandle *args, const char **keys);
int MXTNDArrayLoad(const char *fname, mx_uint *out_size,
                   NDArrayHandle **out_arr, mx_uint *out_name_size,
                   const char ***out_names);
int MXTNDArraySaveRawBytes(NDArrayHandle handle, size_t *out_size,
                           const char **out_buf);
int MXTNDArrayLoadFromRawBytes(const void *buf, size_t size,
                               NDArrayHandle *out);

/* ---- NDArray function registry -------------------------------------- */
int MXTListFunctions(mx_uint *out_size, FunctionHandle **out_array);
int MXTGetFunction(const char *name, FunctionHandle *out);
int MXTFuncGetInfo(FunctionHandle fun, const char **name,
                   const char **description);
int MXTFuncDescribe(FunctionHandle fun, mx_uint *num_used_vars,
                    mx_uint *num_scalars, mx_uint *num_mutate_vars,
                    int *type_mask);
int MXTFuncInvoke(FunctionHandle fun, NDArrayHandle *used_vars,
                  mx_float *scalar_args, NDArrayHandle *mutate_vars);

/* ---- Symbol ---------------------------------------------------------- */
int MXTSymbolListAtomicSymbolCreators(mx_uint *out_size,
                                      AtomicSymbolCreator **out_array);
int MXTSymbolGetAtomicSymbolName(AtomicSymbolCreator creator,
                                 const char **name);
int MXTSymbolGetAtomicSymbolInfo(AtomicSymbolCreator creator,
                                 const char **name, const char **description,
                                 mx_uint *num_args,
                                 const char ***arg_names,
                                 const char ***arg_type_infos,
                                 const char ***arg_descriptions);
int MXTSymbolCreateAtomicSymbol(AtomicSymbolCreator creator,
                                mx_uint num_param, const char **keys,
                                const char **vals, SymbolHandle *out);
int MXTSymbolCreateVariable(const char *name, SymbolHandle *out);
int MXTSymbolCreateGroup(mx_uint num_symbols, SymbolHandle *symbols,
                         SymbolHandle *out);
int MXTSymbolCreateFromFile(const char *fname, SymbolHandle *out);
int MXTSymbolCreateFromJSON(const char *json, SymbolHandle *out);
int MXTSymbolSaveToFile(SymbolHandle symbol, const char *fname);
int MXTSymbolSaveToJSON(SymbolHandle symbol, const char **out_json);
int MXTSymbolFree(SymbolHandle symbol);
int MXTSymbolCopy(SymbolHandle symbol, SymbolHandle *out);
int MXTSymbolPrint(SymbolHandle symbol, const char **out_str);
int MXTSymbolGetAttr(SymbolHandle symbol, const char *key,
                     const char **out, int *success);
int MXTSymbolSetAttr(SymbolHandle symbol, const char *key,
                     const char *value);
int MXTSymbolListArguments(SymbolHandle symbol, mx_uint *out_size,
                           const char ***out_str_array);
int MXTSymbolListOutputs(SymbolHandle symbol, mx_uint *out_size,
                         const char ***out_str_array);
int MXTSymbolListAuxiliaryStates(SymbolHandle symbol, mx_uint *out_size,
                                 const char ***out_str_array);
int MXTSymbolGetInternals(SymbolHandle symbol, SymbolHandle *out);
int MXTSymbolGetOutput(SymbolHandle symbol, mx_uint index,
                       SymbolHandle *out);
/*! keys NULL => positional compose */
int MXTSymbolCompose(SymbolHandle sym, const char *name, mx_uint num_args,
                     const char **keys, SymbolHandle *args);
int MXTSymbolGrad(SymbolHandle sym, mx_uint num_wrt, const char **wrt,
                  SymbolHandle *out);
/*! CSR-packed input shapes (arg_ind_ptr has num_args+1 entries); outputs
 * are thread-local. `complete` is 1 when all shapes were inferred. */
int MXTSymbolInferShape(SymbolHandle sym, mx_uint num_args,
                        const char **keys, const mx_uint *arg_ind_ptr,
                        const mx_uint *arg_shape_data,
                        mx_uint *in_shape_size, const mx_uint **in_shape_ndim,
                        const mx_uint ***in_shape_data,
                        mx_uint *out_shape_size,
                        const mx_uint **out_shape_ndim,
                        const mx_uint ***out_shape_data,
                        mx_uint *aux_shape_size,
                        const mx_uint **aux_shape_ndim,
                        const mx_uint ***aux_shape_data, int *complete);
int MXTSymbolInferShapePartial(SymbolHandle sym, mx_uint num_args,
                               const char **keys, const mx_uint *arg_ind_ptr,
                               const mx_uint *arg_shape_data,
                               mx_uint *in_shape_size,
                               const mx_uint **in_shape_ndim,
                               const mx_uint ***in_shape_data,
                               mx_uint *out_shape_size,
                               const mx_uint **out_shape_ndim,
                               const mx_uint ***out_shape_data,
                               mx_uint *aux_shape_size,
                               const mx_uint **aux_shape_ndim,
                               const mx_uint ***aux_shape_data,
                               int *complete);
int MXTSymbolInferType(SymbolHandle sym, mx_uint num_args,
                       const char **keys, const int *arg_type_data,
                       mx_uint *in_type_size, const int **in_type_data,
                       mx_uint *out_type_size, const int **out_type_data,
                       mx_uint *aux_type_size, const int **aux_type_data,
                       int *complete);

/* ---- Executor -------------------------------------------------------- */
int MXTExecutorFree(ExecutorHandle handle);
int MXTExecutorPrint(ExecutorHandle handle, const char **out_str);
int MXTExecutorForward(ExecutorHandle handle, int is_train);
int MXTExecutorBackward(ExecutorHandle handle, mx_uint len,
                        NDArrayHandle *head_grads);
int MXTExecutorOutputs(ExecutorHandle handle, mx_uint *out_size,
                       NDArrayHandle **out);
/*! grad_req_type: 0 null, 1 write, 2 inplace(=write), 3 add */
int MXTExecutorBind(SymbolHandle symbol_handle, int dev_type, int dev_id,
                    mx_uint len, NDArrayHandle *in_args,
                    NDArrayHandle *arg_grad_store,
                    mx_uint *grad_req_type, mx_uint aux_states_len,
                    NDArrayHandle *aux_states, ExecutorHandle *out);

/* ---- DataIter -------------------------------------------------------- */
int MXTListDataIters(mx_uint *out_size, DataIterCreator **out_array);
int MXTDataIterGetIterInfo(DataIterCreator creator, const char **name,
                           const char **description, mx_uint *num_args,
                           const char ***arg_names,
                           const char ***arg_type_infos,
                           const char ***arg_descriptions);
int MXTDataIterCreateIter(DataIterCreator creator, mx_uint num_param,
                          const char **keys, const char **vals,
                          DataIterHandle *out);
int MXTDataIterFree(DataIterHandle handle);
/*! *out = 1 while batches remain */
int MXTDataIterNext(DataIterHandle handle, int *out);
int MXTDataIterBeforeFirst(DataIterHandle handle);
int MXTDataIterGetData(DataIterHandle handle, NDArrayHandle *out);
int MXTDataIterGetLabel(DataIterHandle handle, NDArrayHandle *out);
int MXTDataIterGetIndex(DataIterHandle handle, uint64_t **out_index,
                        uint64_t *out_size);
int MXTDataIterGetPadNum(DataIterHandle handle, int *pad);

/* ---- KVStore --------------------------------------------------------- */
int MXTKVStoreCreate(const char *type, KVStoreHandle *out);
int MXTKVStoreFree(KVStoreHandle handle);
int MXTKVStoreInit(KVStoreHandle handle, mx_uint num, const int *keys,
                   NDArrayHandle *vals);
int MXTKVStorePush(KVStoreHandle handle, mx_uint num, const int *keys,
                   NDArrayHandle *vals, int priority);
int MXTKVStorePull(KVStoreHandle handle, mx_uint num, const int *keys,
                   NDArrayHandle *vals, int priority);
int MXTKVStoreSetUpdater(KVStoreHandle handle, MXTKVStoreUpdater *updater,
                         void *updater_handle);
int MXTKVStoreGetType(KVStoreHandle handle, const char **type);
int MXTKVStoreGetRank(KVStoreHandle handle, int *rank);
int MXTKVStoreGetGroupSize(KVStoreHandle handle, int *size);
int MXTKVStoreIsWorkerNode(int *ret);
int MXTKVStoreIsServerNode(int *ret);
int MXTKVStoreIsSchedulerNode(int *ret);
int MXTKVStoreBarrier(KVStoreHandle handle);
int MXTKVStoreSendCommmandToServers(KVStoreHandle handle, int cmd_id,
                                    const char *cmd_body);

#ifdef __cplusplus
}
#endif

#endif  /* MXNET_TPU_TORCH_C_API_GRAPH_H_ */
